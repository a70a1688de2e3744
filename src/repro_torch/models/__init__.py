"""Model substrate of the port: parameter trees, layers, and the dense, MoE (GQA or MLA), pure-SSM, hybrid,
encoder-decoder and prefix-LM models."""

from .act_sharding import activation_sharding, constrain
from .convert import load_jax_params
from .params import ParamDef, ParamTree, init_params
from .transformer import Encoder, Transformer, init_cache, model_defs

__all__ = [
    "ParamDef",
    "ParamTree",
    "init_params",
    "Transformer",
    "Encoder",
    "model_defs",
    "init_cache",
    "activation_sharding",
    "constrain",
    "load_jax_params",
]
