"""Configurations of the paper's pricing workloads, and the execution knobs.

:class:`ExecutionConfig` holds every knob that selects *how* a price is
computed.  The port's backends are ``"kernel"`` (the default: the
hand-written CUDA kernels on a card, their plain versions on the CPU)
and ``"torch"`` (the plain PyTorch level walk, the second opinion).
"""
import dataclasses
from typing import Optional

__all__ = ["ExecutionConfig", "PricingConfig", "BACKENDS", "PAPER_PUT",
           "PAPER_BULL", "PAPER_NOTC"]

BACKENDS = ("kernel", "torch")


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How a pricing call executes.

    ``None`` means the default: ``engine`` routes by contract
    (``"auto"``), ``backend`` is ``"kernel"`` and ``device`` is
    ``"cuda"``.  Sharding (``devices``) and the LSMC engine are not
    ported yet and raise ``NotImplementedError`` where they are asked for.
    """
    engine: Optional[str] = None       # "auto" | "notc" | "rz"
    backend: Optional[str] = None      # "kernel" | "torch"
    device: Optional[str] = None       # "cuda" | "cpu"
    devices: Optional[int] = None      # 1-D mesh width: not ported

    def resolved(self) -> "ExecutionConfig":
        backend = self.backend or "kernel"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; use one of "
                             f"{BACKENDS}")
        return dataclasses.replace(self, engine=self.engine or "auto",
                                   backend=backend,
                                   device=self.device or "cuda")


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


PAPER_PUT = PricingConfig(name="paper-put-tc", n_steps=1500, round_depth=5)
PAPER_BULL = PricingConfig(name="paper-bull-tc", n_steps=1500, round_depth=5,
                           payoff="bull_spread", cost_rate=0.01)
PAPER_NOTC = PricingConfig(name="paper-put-notc", n_steps=40000,
                           round_depth=50, cost_rate=0.0, sigma=0.3,
                           rate=0.06, maturity=3.0)
