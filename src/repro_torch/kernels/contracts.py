"""Registry of the port's hand-written kernels, one entry per CUDA kernel.

The counterpart of the JAX package's ``kernels/contracts.py``: the same
names, dtypes and per-dtype tolerances as JAX's ``CONTRACTS`` entries
(the tests hold the two registries equal in both directions).  JAX's
entry bounds two lowerings of one Pallas kernel; here the tolerance
bounds the CUDA kernel against its plain PyTorch version on the card,
in the dtypes the kernel is built for, and ``chip_smoke.py`` and the card
tests read their float32 bounds from it.

``flash_attention`` has a second plain version that repeats its
arithmetic, ``flash_attention_mirror``: the contract's tolerance is held
against that one; ``flash_attention_plain`` sums in another order and is
held to 2e-5, JAX's own kernel-test bound.  The lattice kernels' plain
version repeats their block and halo structure; the full-array oracle
JAX sweeps them against is ``kernels/binomial_ref.py::lattice_levels_ref``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from . import binomial_step, flash_attention, lru_scan, rz_step

__all__ = ["KernelContract", "CONTRACTS", "dtype_name"]


def dtype_name(dtype) -> str:
    """``torch.float32`` or ``"float32"`` -> ``"float32"``."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """One CUDA kernel: its wrapper, plain version, source and the TPU
    kernel it replaces, its dtypes and a tolerance for each."""
    name: str
    wrapper: Callable
    plain: Callable
    source: str                      # the CUDA source, from the repo root
    replaces: str                    # file:line of the TPU kernel
    dtypes: Tuple[str, ...] = ("float64", "float32")
    tol: Tuple[Tuple[str, float], ...] = (("float64", 1e-12),
                                          ("float32", 1e-5))

    def tolerance(self, dtype) -> float:
        return dict(self.tol)[dtype_name(dtype)]


_CSRC = "src/repro_torch/csrc/"

CONTRACTS: Dict[str, KernelContract] = {c.name: c for c in [
    KernelContract(
        name="rz_round",
        wrapper=rz_step.rz_round, plain=rz_step.rz_round_plain,
        source=_CSRC + "rz_step.cu",
        replaces="src/repro/kernels/rz_step.py:72",
        tol=(("float64", 1e-12), ("float32", 1e-4))),
    KernelContract(
        name="lattice_round",
        wrapper=binomial_step.lattice_round,
        plain=binomial_step.lattice_round_plain,
        source=_CSRC + "binomial_step.cu",
        replaces="src/repro/kernels/binomial_step.py:67"),
    KernelContract(
        name="lattice_round_param",
        wrapper=binomial_step.lattice_round_param,
        plain=binomial_step.lattice_round_plain,
        source=_CSRC + "binomial_step.cu",
        replaces="src/repro/kernels/binomial_step.py:87"),
    # the LM kernels' entries are float32 only, as JAX declares them.
    # flash_attention also has a bfloat16 instance (what JAX's kernel
    # computes for bfloat16 inputs, tests/test_kernels_attention.py:20);
    # its bounds stand beside the wrapper (BF16_PLAIN_TOL, the mirror's
    # MIRROR_REL_BF16), so that this registry stays equal to JAX's
    KernelContract(
        name="flash_attention",
        wrapper=flash_attention.flash_attention,
        plain=flash_attention.flash_attention_plain,
        source=_CSRC + "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:29",
        dtypes=("float32",), tol=(("float32", 2e-6),)),
    KernelContract(
        name="lru_scan",
        wrapper=lru_scan.lru_scan, plain=lru_scan.lru_scan_plain,
        source=_CSRC + "lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:31",
        dtypes=("float32",), tol=(("float32", 2e-6),)),
]}
