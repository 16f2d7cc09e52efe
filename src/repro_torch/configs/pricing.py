"""Configurations of the paper's pricing workloads, and the execution knobs.

:class:`ExecutionConfig` holds every knob that selects *how* a price is
computed.  The port's backends are ``"kernel"`` (the default: the
hand-written CUDA kernels on a card, their plain versions on the CPU)
and ``"torch"`` (the plain PyTorch level walk, the second opinion).
:meth:`PricingConfig.execution` maps a workload's JAX-style
``platform``/``interpret`` onto it, as the API's individual kwargs are
mapped; :meth:`PricingConfig.resolve_execution` resolves the three knobs
against ``core/platform.py``'s policy, as JAX's does.
"""
import dataclasses
from typing import Optional

__all__ = ["ExecutionConfig", "PricingConfig", "BACKENDS", "PAPER_PUT",
           "PAPER_BULL", "PAPER_NOTC", "LEGACY_BACKENDS", "execution_device"]

BACKENDS = ("kernel", "torch")
# the JAX package's backend and platform names -> the port's
LEGACY_BACKENDS = {"jnp": "torch", "pallas": "kernel"}
_LEGACY_PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


def execution_device(platform=None, interpret=None, backend=None):
    """``(device, backend)`` from the JAX package's ``platform``,
    ``interpret`` and ``backend``: ``"gpu"`` -> ``"cuda"``, ``"cpu"`` ->
    ``"cpu"`` (``"tpu"`` raises ``ValueError``); ``"jnp"`` -> ``"torch"``,
    ``"pallas"`` -> ``"kernel"``; ``interpret=True`` (the kernels'
    semantics off the card) -> ``device="cpu"`` and, unless ``backend``
    says otherwise, ``"kernel"``: the kernels' plain versions.  It raises
    ``ValueError`` beside ``platform="gpu"``, as ``interpret=False`` (the
    compiled kernels) does beside ``"cpu"``.  ``None`` stays ``None``."""
    device = None
    if platform is not None:
        if platform not in _LEGACY_PLATFORMS:
            raise ValueError(f"platform {platform!r} is not a platform of "
                             f"the port; use one of "
                             f"{tuple(_LEGACY_PLATFORMS)}")
        device = _LEGACY_PLATFORMS[platform]
    if backend is not None:
        backend = LEGACY_BACKENDS.get(backend, backend)
    if interpret is not None:
        if interpret and device == "cuda":
            raise ValueError("interpret=True runs the kernels' plain "
                             "versions on the CPU; it contradicts "
                             "platform='gpu'")
        if not interpret and device == "cpu":
            raise ValueError("interpret=False runs the compiled kernels on "
                             "the card; it contradicts platform='cpu'")
        if interpret:
            device = "cpu"
            backend = backend or "kernel"
    return device, backend


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How a pricing call executes.

    ``None`` means the default: ``engine`` routes by contract
    (``"auto"``), ``backend`` is ``"kernel"``, ``device`` is ``"cuda"``,
    ``devices`` stays single-device, and the LSMC statics take the JAX
    package's defaults (4096 paths, seed 0, ``"poly"`` of degree 3,
    antithetic).  Frozen and hashable; ``devices`` is a count, each call
    resolves its own mesh (``core/distributed.py``).
    """
    engine: Optional[str] = None       # "auto" | "notc" | "rz" | "lsmc"
    backend: Optional[str] = None      # "kernel" | "torch"
    device: Optional[str] = None       # "cuda" | "cpu"
    devices: Optional[int] = None      # 1-D mesh width (count, not a mesh)
    n_paths: Optional[int] = None      # lsmc paths
    mc_seed: Optional[int] = None      # lsmc seed
    basis: Optional[str] = None        # lsmc regression basis
    degree: Optional[int] = None       # ... and its degree
    antithetic: Optional[bool] = None  # lsmc antithetic pairing

    def set_fields(self) -> tuple:
        """Names of the fields explicitly set (non-``None``)."""
        return tuple(f.name for f in dataclasses.fields(self)
                     if getattr(self, f.name) is not None)

    def resolved(self) -> "ExecutionConfig":
        backend = self.backend or "kernel"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use one of "
                             f"{BACKENDS}")
        return dataclasses.replace(
            self, engine=self.engine or "auto", backend=backend,
            device=self.device or "cuda",
            n_paths=4096 if self.n_paths is None else int(self.n_paths),
            mc_seed=0 if self.mc_seed is None else int(self.mc_seed),
            basis=self.basis or "poly",
            degree=3 if self.degree is None else int(self.degree),
            antithetic=(True if self.antithetic is None
                        else bool(self.antithetic)))


@dataclasses.dataclass(frozen=True)
class PricingConfig:
    name: str
    n_steps: int
    capacity: int = 48           # PWL knots per node
    round_depth: int = 8         # L — levels per halo round
    contracts: int = 256         # batch of contracts
    cost_rate: float = 0.005
    payoff: str = "put"          # put | call | bull_spread
    strike: float = 100.0
    s0: float = 100.0
    sigma: float = 0.2
    rate: float = 0.1
    maturity: float = 0.25
    # execution policy in the JAX package's terms (None = the port's
    # default: the kernels on the card)
    platform: Optional[str] = None    # "cpu" | "gpu"
    interpret: Optional[bool] = None  # True: the kernels' plain versions
    dtype: Optional[str] = None       # "float64" | "float32"

    def resolve_execution(self) -> dict:
        """The execution knobs resolved against the platform policy
        (``core/platform.py``), as the JAX package's method returns them:
        ``{"platform", "interpret", "dtype"}`` with each ``None`` replaced
        by the active platform's value (``interpret`` and float64 on
        ``"cpu"``, the kernels and float32 on ``"gpu"``; ``"tpu"`` raises
        ``ValueError``)."""
        from ..core import platform as plat
        if self.dtype not in (None, "float64", "float32"):
            raise ValueError(f"dtype {self.dtype!r}: use 'float64' or "
                             "'float32'")
        p = self.platform or plat.active_platform()
        return {"platform": p,
                "interpret": plat.resolve_interpret(self.interpret, p),
                "dtype": self.dtype or plat.policy_dtype(p)}

    def execution(self) -> ExecutionConfig:
        """This workload's execution knobs as the port's resolved
        :class:`ExecutionConfig`: ``platform`` ``"gpu"``/``"cpu"`` ->
        ``device`` ``"cuda"``/``"cpu"``, ``interpret=True`` -> the
        kernels' plain versions on the CPU (``ValueError`` beside
        ``platform="gpu"``, as ``interpret=False`` beside ``"cpu"``).

        ``dtype`` (``"float64"`` or ``"float32"``, else ``ValueError``)
        does not reach the :class:`ExecutionConfig`, as in the JAX
        package: the scenario grids it drives compute in float64 in both
        packages, whatever the dtype says.  The float32 paths are the
        node-axis builders and the kernel walks, which take ``dtype``
        themselves."""
        if self.dtype not in (None, "float64", "float32"):
            raise ValueError(f"dtype {self.dtype!r}: use 'float64' or "
                             "'float32'")
        device, backend = execution_device(self.platform, self.interpret)
        return ExecutionConfig(device=device, backend=backend).resolved()


PAPER_PUT = PricingConfig(name="paper-put-tc", n_steps=1500, round_depth=5)
PAPER_BULL = PricingConfig(name="paper-bull-tc", n_steps=1500, round_depth=5,
                           payoff="bull_spread", cost_rate=0.01)
PAPER_NOTC = PricingConfig(name="paper-put-notc", n_steps=40000,
                           round_depth=50, cost_rate=0.0, sigma=0.3,
                           rate=0.06, maturity=3.0)
