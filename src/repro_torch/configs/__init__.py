"""Configurations: the paper's pricing workloads (``configs.pricing``)
and the language-model architectures the port serves
(``configs.base``, one module per architecture)."""
from .base import (  # noqa: F401
    ModelConfig, MoEConfig, RecurrentConfig, SSMConfig, get_config,
    list_archs, reduced_config, register,
)
