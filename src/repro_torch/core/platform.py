"""Platform policy of the port: ``platform={cpu,gpu,tpu}``.

The counterpart of the JAX package's ``core/platform.py``, with its
names and its policy table:

* ``cpu``: ``interpret=True`` (here: the kernels' plain PyTorch
  versions) and float64;
* ``gpu``: the hand-written CUDA kernels and float32, the dtype the JAX
  package runs its pricing kernels in on an accelerator;
* ``tpu`` is in the table, as in JAX's, but the port has no TPU path:
  :func:`resolve_interpret` and :func:`default_dtype` raise
  ``ValueError`` for it, as ``configs/pricing.py::execution_device``
  does.

The policy decides defaults only: a ``dtype=None`` or ``interpret=None``
knob resolves through it (``kernels/ops.py::price_notc_kernel``,
``configs/pricing.py::PricingConfig.resolve_execution``).  Engines that
the JAX package holds at float64 (the scenario grids, the service) keep
``core/device.py::DEFAULT_DTYPE``.  JAX's ``configure_jax``, XLA flags and
``jax_platform_name`` have no PyTorch counterpart: :func:`set_platform`
changes the policy alone.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PLATFORMS", "PlatformPolicy", "POLICIES", "detect_platform",
           "active_platform", "set_platform", "resolve_interpret",
           "default_dtype", "policy_dtype", "platform_summary"]

PLATFORMS = ("cpu", "gpu", "tpu")


@dataclasses.dataclass(frozen=True)
class PlatformPolicy:
    """Per-platform defaults, JAX's fields: ``interpret`` True means the
    plain versions, ``compiled_pallas`` that the platform runs compiled
    kernels (here: the CUDA ones)."""
    platform: str
    interpret: bool
    compiled_pallas: bool
    default_dtype: str         # "float64" | "float32"


POLICIES: dict = {
    "cpu": PlatformPolicy("cpu", interpret=True, compiled_pallas=False,
                          default_dtype="float64"),
    "gpu": PlatformPolicy("gpu", interpret=False, compiled_pallas=True,
                          default_dtype="float32"),
    "tpu": PlatformPolicy("tpu", interpret=False, compiled_pallas=True,
                          default_dtype="float32"),
}

# the platform pinned by set_platform(); None: detect
_OVERRIDE: str | None = None


def _validate(platform: str) -> str:
    platform = str(platform).lower()
    if platform not in PLATFORMS:
        raise ValueError(
            f"unknown platform {platform!r}; expected one of {PLATFORMS}")
    return platform


def _policy(platform: str | None) -> PlatformPolicy:
    key = _validate(platform) if platform is not None else active_platform()
    if key == "tpu":
        raise ValueError("platform 'tpu' has no path in the port; use "
                         "'gpu' (the CUDA kernels) or 'cpu'")
    return POLICIES[key]


def detect_platform() -> str:
    """``"gpu"`` where PyTorch sees a CUDA card, else ``"cpu"``."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def active_platform() -> str:
    """The pinned platform if any, else the detected one."""
    return _OVERRIDE if _OVERRIDE is not None else detect_platform()


def set_platform(platform: str | None) -> str:
    """Pin the platform the policy resolves for (``None``: detect again);
    returns the active platform."""
    global _OVERRIDE
    _OVERRIDE = None if platform is None else _validate(platform)
    return active_platform()


def resolve_interpret(interpret: bool | None = None,
                      platform: str | None = None) -> bool:
    """An ``interpret=`` knob: explicit wins, else the platform's."""
    if interpret is not None:
        return bool(interpret)
    return _policy(platform).interpret


def policy_dtype(platform: str | None = None) -> str:
    """The platform's dtype as JAX names it: ``"float64"`` or
    ``"float32"``."""
    return _policy(platform).default_dtype


def default_dtype(platform: str | None = None) -> torch.dtype:
    """The platform's dtype as a ``torch.dtype``."""
    return getattr(torch, policy_dtype(platform))


def platform_summary() -> dict:
    """The resolved policy in one dict, JAX's keys where they carry over
    (no ``xla_flags``; ``torch_version`` for ``jax_version``)."""
    key = active_platform()
    pol = POLICIES[key]
    return {"platform": key, "detected": detect_platform(),
            "interpret": pol.interpret,
            "compiled_pallas": pol.compiled_pallas,
            "default_dtype": pol.default_dtype,
            "torch_version": torch.__version__}
