"""The port's mesh and its collectives: the stand-in for the collectives
XLA inserts for the JAX package over its ``jax.sharding.Mesh``.

A ``Mesh`` is a named grid over the ranks of the default process group
(row-major: rank = d * tp + m on a (data, model) mesh), with one process
group per axis slice. Every collective here is built on one primitive,
``all_reduce`` (a sum) over an axis:

- ``all_gather`` and ``ppermute`` and ``broadcast`` reduce a buffer in
  which each rank has written its own slot and left the others at -0.0
  (0 for integers). -0.0 is the identity of IEEE addition (x + -0.0 == x
  for every x, signed zeros included), so they move bits exactly.
- So one code path runs on gloo over CPU tensors (the tests) and over
  CUDA tensors, where gloo takes only ``broadcast`` and ``all_reduce``
  (ranks that share one card: NCCL refuses two ranks on one device).
- The price: ``all_gather`` and ``ppermute`` each reduce a [K, ...]
  buffer, so every rank holds K times x and the wire carries K times
  x's bytes, where a native gather or send/recv would move x once.
  ``broadcast_gather`` gathers large buffers (the ZeRO-1 slices) by K
  native broadcasts instead, each byte crossing once.

The transport is gloo (``TRANSPORT``, the default group's backend,
``Mesh.transport``), never switched quietly; gloo copies a CUDA tensor
through host memory itself. NCCL waits for a machine with one card per
rank to run it on.

Training differentiates through three of them, megatron's pair and a
gather, each a ``torch.autograd.Function`` over an axis:

- ``copy_to`` (megatron's *f*): the identity forward, the sum of the
  gradient over the axis backward. It stands before a column-parallel
  product, whose input gradient on each rank is its local columns' share.
- ``reduce_from`` (*g*): the sum over the axis forward, the identity
  backward: a row-parallel product's partial sums, or a loss's numerator
  summed over ``data``.
- ``gather_from``: the ranks' slices concatenated forward; backward, this
  rank's slice of the gradient (the consumer is replicated, so every rank
  holds the whole gradient and no reduction is needed).

Each is the identity on an axis of one rank. ``all_reduce`` itself is not
differentiated: the trainers sum their gradients over ``data`` with it.

``METER`` times the collectives when it is on (``metered``): each call
then waits for the device before and after, so its seconds are the
collective's own and not the queued compute's.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


TRANSPORT = "gloo"


def init(rank: int, world: int, store: str) -> None:
    """Join the default process group of ``world`` ranks over
    ``TRANSPORT``, meeting at the file store ``store``: a path in a
    directory the spawner made for this world (a file store is not
    reused). A file store needs no port. A port picked free by the
    spawner and handed to the ranks stays free only until some other
    process on the host binds it, which it may do before rank 0 listens
    there."""
    dist.init_process_group(TRANSPORT, init_method=f"file://{store}",
                            rank=rank, world_size=world)


def leave() -> None:
    """Leave the default process group once this rank's work is done:
    wait for every rank, then destroy the group, so its threads are
    joined before the process exits. A process that exits with the group
    alive leaves their teardown to the interpreter's, which can abort the
    rank (``terminate called without an active exception``, SIGABRT)
    after all of its work succeeded."""
    dist.barrier()
    dist.destroy_process_group()


class Mesh:
    """A named mesh over the ranks of the default process group.

    ``shape`` maps each axis name to its size (``mesh.shape["model"]``, as
    in JAX), ``coords`` to this rank's index along it. A mesh of one rank
    needs no process group: every collective over it is the identity.
    Every rank must build the same meshes in the same order (each builds
    every axis slice's group, as ``dist.new_group`` requires)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        sizes = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {sizes} and axis names "
                             f"{self.axis_names} differ in length")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        if self.size == 1:
            self.rank, self.backend = 0, None
        else:
            if not dist.is_initialized():
                raise RuntimeError(f"a mesh of {self.size} ranks needs the "
                                   f"default process group (comm.init)")
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh of {self.size} ranks over a world "
                                 f"of {dist.get_world_size()}")
            self.rank, self.backend = dist.get_rank(), dist.get_backend()
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, sizes))))
        grid = np.arange(self.size).reshape(sizes)
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for i, name in enumerate(self.axis_names):
            self._groups[name] = None
            if sizes[i] == 1:
                continue
            for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = group

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's slice along ``axis`` (None for
        an axis of size 1)."""
        return self._groups[axis]

    @property
    def transport(self) -> str:
        return "none (one rank)" if self.backend is None else self.backend

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, coords "
                f"{self.coords}, {self.transport})")


class Meter:
    """Seconds, calls and bytes of the collectives while ``enabled``."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self) -> None:
        self.seconds, self.calls, self.bytes = 0.0, 0, 0


METER = Meter()


@contextlib.contextmanager
def metered():
    """Time every collective inside the block (``METER``, reset first)."""
    METER.reset()
    METER.enabled = True
    try:
        yield METER
    finally:
        METER.enabled = False


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _metered(buf: torch.Tensor):
    """Count the collective on ``buf`` inside the block into ``METER``."""
    t0 = 0.0
    if METER.enabled:
        _sync(buf)
        t0 = time.perf_counter()
    yield
    if METER.enabled:
        _sync(buf)
        METER.seconds += time.perf_counter() - t0
        METER.calls += 1
        METER.bytes += buf.numel() * buf.element_size()


def _reduce_(buf: torch.Tensor, mesh: Mesh, group) -> None:
    """Sum ``buf`` over ``group`` in place."""
    with _metered(buf):
        dist.all_reduce(buf, group=group)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over ``axis`` (a new tensor; x itself is left)."""
    group = mesh.group(axis)
    if group is None:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    _reduce_(out, mesh, group)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh is here (nothing on one rank)."""
    if mesh.size > 1:
        dist.barrier()


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x summed over ``axis`` in place (x contiguous); returns x. Not
    differentiated: the trainers sum their gradients over ``data`` with
    it."""
    group = mesh.group(axis)
    if group is not None:
        _reduce_(x, mesh, group)
    return x


def _slots(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[K, *x.shape] with x in this rank's slot along ``axis`` and the
    identity of addition elsewhere, summed over the axis: every rank's x
    in its slot, bitwise."""
    k = mesh.shape[axis]
    fill = -0.0 if x.is_floating_point() else 0
    buf = torch.full((k,) + tuple(x.shape), fill, dtype=x.dtype,
                     device=x.device)
    buf[mesh.coords[axis]] = x
    _reduce_(buf, mesh, mesh.group(axis))
    return buf


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in their order along
    ``axis`` (JAX's ``all_gather(..., tiled=True)``)."""
    if mesh.group(axis) is None:
        return x
    return torch.cat(list(_slots(x, mesh, axis)), dim=dim)


def broadcast_gather(x: torch.Tensor, mesh: Mesh, axis: str,
                     dim: int = 0) -> torch.Tensor:
    """``all_gather``'s result, bitwise, by one native broadcast from each
    rank of the axis in turn: each byte crosses once, where the slots of
    ``all_gather`` carry K times x. For large buffers (gloo takes
    ``broadcast`` for CUDA tensors); ranks hold the same x shape."""
    group = mesh.group(axis)
    if group is None:
        return x
    parts = []
    for j in range(mesh.shape[axis]):
        buf = x.clone(memory_format=torch.contiguous_format) \
            if j == mesh.coords[axis] else torch.empty_like(
                x, memory_format=torch.contiguous_format)
        with _metered(buf):
            dist.broadcast(buf, src=dist.get_global_rank(group, j),
                           group=group)
        parts.append(buf)
    return torch.cat(parts, dim=dim)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """JAX's ``lax.ppermute``: the x of the rank that ``perm`` (pairs of
    (source, destination) indices along ``axis``) sends here, zeros where
    none does."""
    if mesh.group(axis) is None:
        src = [s for s, d in perm if d == 0]
        return x.clone() if src else torch.zeros_like(x)
    me = mesh.coords[axis]
    src = [s for s, d in perm if d == me]
    slots = _slots(x, mesh, axis)
    return slots[src[0]].clone() if src else torch.zeros_like(x)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str,
              src: int) -> torch.Tensor:
    """The x of the rank at index ``src`` along ``axis``, on every rank
    of the slice (JAX's masked psum), bitwise."""
    group = mesh.group(axis)
    if group is None:
        return x
    if mesh.coords[axis] == src:
        out = x.clone(memory_format=torch.contiguous_format)
    else:
        fill = -0.0 if x.is_floating_point() else 0
        out = torch.full(x.shape, fill, dtype=x.dtype, device=x.device)
    _reduce_(out, mesh, group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        me = ctx.mesh.coords[ctx.axis]
        return g.narrow(ctx.dim, me * ctx.size, ctx.size), None, None, None


def copy_to(x: torch.Tensor, mesh: Optional[Mesh],
            axis: str = "model") -> torch.Tensor:
    """x forward; its gradient summed over ``axis`` backward (megatron's
    *f*). x itself without a mesh, on an axis of one rank or where
    autograd records nothing (the decode paths)."""
    if mesh is None or mesh.group(axis) is None \
            or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh],
                axis: str = "model") -> torch.Tensor:
    """The sum of x over ``axis`` forward; the gradient as it is backward
    (megatron's *g*). x itself without a mesh or on an axis of one
    rank."""
    if mesh is None or mesh.group(axis) is None:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh: Optional[Mesh], axis: str = "model",
                dim: int = -1) -> torch.Tensor:
    """``all_gather`` of x along ``dim`` forward; this rank's slice of the
    gradient backward. x itself without a mesh or on an axis of one
    rank."""
    if mesh is None or mesh.group(axis) is None:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())
