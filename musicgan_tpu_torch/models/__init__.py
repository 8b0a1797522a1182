"""Network components of the synthesis path: the generator, its layers
and its checkpoint ingest."""

from ..config import ModelConfig
from .generator import Generator, generator_param_count
from .torch_ingest import load_reference_generator, params_from_jax

__all__ = [
    "Generator",
    "ModelConfig",
    "generator_param_count",
    "load_reference_generator",
    "params_from_jax",
]
