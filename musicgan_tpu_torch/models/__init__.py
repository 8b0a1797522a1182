"""Network components: the generator, the critic, their layers, the
losses and the checkpoint / JAX-state ingest."""

from ..config import ModelConfig
from .discriminator import (
    Discriminator,
    critic_input_grad_nchw_train,
    discriminator_param_count,
)
from .generator import Generator, generator_param_count
from .losses import (
    discriminator_loss,
    generator_loss,
    wasserstein_discriminator_loss,
    wasserstein_generator_loss,
)
from .torch_ingest import (
    adam_state_from_jax,
    adam_state_to_jax_layout,
    disc_params_from_jax,
    load_reference_generator,
    params_from_jax,
    params_to_jax_layout,
    train_state_from_jax,
)

__all__ = [
    "Discriminator",
    "Generator",
    "ModelConfig",
    "adam_state_from_jax",
    "adam_state_to_jax_layout",
    "critic_input_grad_nchw_train",
    "disc_params_from_jax",
    "discriminator_loss",
    "discriminator_param_count",
    "generator_loss",
    "generator_param_count",
    "load_reference_generator",
    "params_from_jax",
    "params_to_jax_layout",
    "train_state_from_jax",
    "wasserstein_discriminator_loss",
    "wasserstein_generator_loss",
]
