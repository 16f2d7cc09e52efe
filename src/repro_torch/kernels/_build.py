"""Build the CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into
``build/repro_torch/lib<name>.so`` at the repository root (a directory
git ignores).  The sources have a plain C interface: device pointers and
the stream go in as ``c_void_p``, and every entry point returns
``cudaGetLastError()`` so the wrapper can raise on a refused launch.

``--fmad=false``: the PWL algebra decides knot retention and crossings
with threshold tests at a relative 1e-9, and a contracted multiply-add
rounds differently from the plain version's separate multiply and add.
That can change a knot count and with it ``max_pieces``.

``-Xptxas=-v``: each kernel's registers, stack and spills go into the
build's output, which ``build_all`` returns.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "build_all", "check",
           "refuse_grad"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc_command(name: str, out: pathlib.Path) -> list:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all(names) -> dict:
    """Compile several sources at once, one ``nvcc`` each, all started
    together; returns ``{name: nvcc output}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            _nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built at first use.

    ``signatures`` maps each entry point to its ``argtypes``; every entry
    point returns an int (a ``cudaError_t``).
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            src = CSRC / f"{name}.cu"
            newest = max(x.stat().st_mtime for x in
                         [src, *CSRC.glob("*.cuh")])
            if not path.exists() or path.stat().st_mtime < newest:
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a call of a kernel that has no
    backward: its output would carry no ``grad_fn``, so every gradient
    upstream of it would silently be zero.  Checked on every device, so
    that a CPU run fails where a run on the card would."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() or on "
            f"inputs that do not require grad")
