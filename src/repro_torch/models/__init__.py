"""Model zoo of the port: layers, MoE, Mamba2 SSD, decoder stacks and the
factory, in plain torch on one device."""

from .model import build_model, default_flags, input_specs, make_batch
from .params import (abstract_params, count_params, init_params, param_specs,
                     pdef, stack_defs, tree_bytes)
from .transformer import Model, RunFlags

__all__ = [
    "Model",
    "RunFlags",
    "abstract_params",
    "build_model",
    "count_params",
    "default_flags",
    "init_params",
    "input_specs",
    "make_batch",
    "param_specs",
    "pdef",
    "stack_defs",
    "tree_bytes",
]
