"""Logical -> physical sharding rules, and the rank mesh's collectives.

The port of the JAX package's ``models/sharding.py``.  Parameters and
activations carry *logical* axes; a :class:`MeshRules` maps them onto a
mesh's physical axes (``(data, model)`` or ``(pod, data, model)``):

    fsdp  the parameter / optimizer-state axis; ("data",) or ("pod", "data")
    tp    the tensor-parallel axis (heads / ffn / vocab / experts); ("model",)
    dp    the batch axis of activations; the same physical axes as fsdp

A dimension that does not divide by its physical axes' size is
replicated instead (recurrentgemma's 10 heads on a 16-way model axis).

**The rank layout.**  JAX runs one SPMD program over a mesh of devices
(``shard_map`` bodies and GSPMD constraints).  The port runs one process
a mesh place (a *rank*, one card each; ``launch/mesh.py`` sets them up)
over ``torch.distributed``, and each rank executes what a ``shard_map``
body executes on its device: ``psum``/``pmax`` are ``all_reduce``s over
the ranks of an axis, ``ppermute`` is ``batch_isend_irecv``, and
``axis_index`` is the rank's coordinate in a
``torch.distributed.device_mesh.DeviceMesh``.  What is laid out on each
rank:

* a batch is split over ``dp``: each rank holds its slice (Megatron's
  layout, and JAX's ``PS(dp)``);
* activations are replicated over ``tp``;
* parameters are replicated, except the experts of an expert-parallel
  MoE, which each rank of the ``tp`` axis holds a slice of
  (:meth:`MeshRules.expert_slice`, JAX's ``PS(tp)`` in ``moe_dispatch``).

A mesh given as :class:`MeshShape` (axis names and sizes, no process
group) serves the spec logic alone: the production shapes (16, 16) and
(2, 16, 16) can be checked in one process.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["MeshShape", "MeshRules", "logical", "mesh_sizes", "axis_index",
           "psum_", "pmax_", "all_gather", "ppermute", "sum_forward",
           "sum_backward"]

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names with no process group behind it
    (JAX's ``AbstractMesh``): ``shape`` is ``{name: size}`` as JAX's
    ``mesh.shape``."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} do not fit the axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a :class:`MeshShape` or a
    ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _rank_mesh(mesh):
    if isinstance(mesh, MeshShape):
        raise TypeError("a MeshShape has no ranks: collectives need a "
                        "DeviceMesh (launch/mesh.py::make_rank_mesh)")
    return mesh


def axis_index(mesh, axes: Axes) -> int:
    """This rank's coordinate on ``axes`` (JAX's ``axis_index``), several
    axes flattened in order, the last fastest."""
    idx = 0
    for name in _names(axes):
        m = _rank_mesh(mesh)
        idx = idx * mesh_sizes(m)[name] + m.get_local_rank(name)
    return idx


def psum_(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axes`` (JAX's ``psum``): one
    ``all_reduce`` an axis.  Every rank receives the same bits."""
    for name in _names(axes):
        dist.all_reduce(t, group=_rank_mesh(mesh).get_group(name))
    return t


def pmax_(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """JAX's ``pmax``, in place."""
    for name in _names(axes):
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=_rank_mesh(mesh).get_group(name))
    return t


def all_gather(t: torch.Tensor, mesh, axes: Axes, dim: int = 0):
    """The ranks' ``t`` concatenated along ``dim`` in the order of
    :func:`axis_index` over ``axes`` (JAX's ``all_gather(tiled=True)``)."""
    out = t
    for name in reversed(_names(axes)):
        group = _rank_mesh(mesh).get_group(name)
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, out.contiguous(), group=group)
        out = torch.cat(parts, dim=dim)
    return out


def ppermute(t: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """JAX's ``ppermute`` by a cyclic shift along ``axis``: the rank at
    coordinate ``i`` sends ``t`` to ``i + shift`` and returns what
    ``i - shift`` sent (``shift=-1``: blocks move left one rank)."""
    m = _rank_mesh(mesh)
    size = mesh_sizes(m)[axis]
    if size == 1 or shift % size == 0:
        return t
    me = m.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(m.get_group(axis))
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t.contiguous(), ranks[(me + shift) % size]),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % size])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_(g.clone(), ctx.mesh, ctx.axes), None, None


def sum_forward(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``psum`` over ``axes`` whose gradient is the identity: where the
    loss downstream is computed alike on every rank of ``axes`` (a
    tensor-parallel combine, a global mean), each rank's gradient is
    then its own share of the global one."""
    return _SumForward.apply(x, mesh, axes)


def sum_backward(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The identity whose gradient is summed over ``axes``: where a tensor
    replicated over ``axes`` enters work that each rank does for its own
    part (its experts), the ranks' gradients of it add up (Megatron's
    ``f``; :func:`sum_forward` is its ``g``)."""
    return _SumBackward.apply(x, mesh, axes)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """JAX's ``MeshRules`` over a ``DeviceMesh`` (or a :class:`MeshShape`
    for the spec logic alone)."""
    mesh: object
    fsdp: Tuple[str, ...] = ("data",)
    tp: Tuple[str, ...] = ("model",)

    @property
    def dp(self) -> Tuple[str, ...]:
        return self.fsdp

    def axis_size(self, names: Tuple[str, ...]) -> int:
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in names)

    def resolve(self, logical_axis: Optional[str], dim_size: int):
        """Map one logical axis name to mesh axes, with divisibility check."""
        if logical_axis is None:
            return None
        names = {"fsdp": self.fsdp, "dp": self.fsdp, "tp": self.tp}[logical_axis]
        if not names:                        # axis role absent on this mesh
            return None
        if dim_size % self.axis_size(names) != 0:
            return None                      # replicate (fallback)
        return names if len(names) > 1 else names[0]

    def spec(self, *axes: Optional[str],
             shape: Optional[Tuple[int, ...]] = None) -> tuple:
        """JAX's ``PartitionSpec`` entries from logical axis names, as a
        tuple (an entry: None, a mesh axis name, or a tuple of names).
        ``shape`` (same length) enables the divisibility fallback; without
        it the mapping is unchecked."""
        out = []
        for i, ax in enumerate(axes):
            if ax is None:
                out.append(None)
            elif shape is None:
                names = {"fsdp": self.fsdp, "dp": self.fsdp,
                         "tp": self.tp}[ax]
                out.append(names if len(names) > 1 else names[0])
            else:
                out.append(self.resolve(ax, shape[i]))
        return tuple(out)

    def index(self, axes: Axes) -> int:
        """This rank's coordinate over ``axes`` (:func:`axis_index`)."""
        return axis_index(self.mesh, axes)

    def dp_slice(self, n: int) -> slice:
        """This rank's part of a batch of ``n`` rows split over ``dp``
        (JAX's ``PS(dp)``); ``n`` must divide."""
        size = self.axis_size(self.dp)
        if n % size:
            raise ValueError(f"batch {n} must divide the data axes {self.dp} "
                             f"of size {size}")
        per = n // size
        lo = self.index(self.dp) * per
        return slice(lo, lo + per)

    def expert_slice(self, num_experts: int) -> Optional[slice]:
        """The experts this rank holds under expert parallelism over
        ``tp`` (JAX's ``moe_dispatch`` in_specs ``PS(tp)``): a contiguous
        block of ``num_experts / tp``, or None where every rank holds all
        of them (one tp rank, or ``num_experts % tp != 0``: JAX then runs
        ``moe_dense``)."""
        size = self.axis_size(self.tp)
        if size == 1 or num_experts % size:
            return None
        per = num_experts // size
        lo = self.index(self.tp) * per
        return slice(lo, lo + per)


def logical(x: torch.Tensor, rules: MeshRules,
            *axes: Optional[str]) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` by logical axis names.  Under the
    rank layout an activation already is its rank's shard (a ``dp`` slice
    of the batch, replicated over ``tp``), so nothing moves: the axes
    are checked against ``x`` (one a dimension, each a logical name) and
    ``x`` is returned as it is."""
    if len(axes) != x.dim() or any(a not in (None, "dp", "fsdp", "tp")
                                   for a in axes):
        raise ValueError(f"logical axes {axes} do not fit a tensor of shape "
                         f"{tuple(x.shape)}")
    return x
