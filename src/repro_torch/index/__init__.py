"""One table group's device state, its build and its query step, and
the streaming primitives (delta memtables, sealed segments, exact scan)."""

from .builder import (append_to_state, build_group_state, build_input_specs,
                      build_state, fold_center_weight, make_build_step,
                      pad_cols, seal_segment)
from .config import IndexConfig, pad_beta, pad_levels
from .engine import (QueryState, QueryStepCache, encode_queries,
                     make_query_step, query_input_specs, query_step,
                     shardings)
from .streaming import DeltaSegment, SealedSegment, exact_weighted_lp, scan_topk

__all__ = [
    "DeltaSegment",
    "IndexConfig",
    "QueryState",
    "QueryStepCache",
    "SealedSegment",
    "append_to_state",
    "build_group_state",
    "build_input_specs",
    "build_state",
    "encode_queries",
    "exact_weighted_lp",
    "fold_center_weight",
    "make_build_step",
    "make_query_step",
    "pad_beta",
    "pad_cols",
    "pad_levels",
    "query_input_specs",
    "query_step",
    "scan_topk",
    "seal_segment",
    "shardings",
]
