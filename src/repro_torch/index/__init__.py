"""One table group's device state, its build and its query step."""

from .builder import build_group_state, pad_cols
from .config import IndexConfig, pad_beta, pad_levels
from .engine import QueryState, QueryStepCache, encode_queries, query_step

__all__ = [
    "IndexConfig",
    "QueryState",
    "QueryStepCache",
    "build_group_state",
    "encode_queries",
    "pad_beta",
    "pad_cols",
    "pad_levels",
    "query_step",
]
