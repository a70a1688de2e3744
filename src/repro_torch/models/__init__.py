"""Model substrate of the port: parameter trees, layers, the dense decoder."""

from .convert import load_jax_params
from .params import ParamDef, ParamTree, init_params
from .transformer import Transformer, check_supported, model_defs

__all__ = [
    "ParamDef",
    "ParamTree",
    "init_params",
    "Transformer",
    "check_supported",
    "model_defs",
    "load_jax_params",
]
