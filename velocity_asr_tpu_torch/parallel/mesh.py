"""Process groups, the (data, model) mesh, and the collectives the
parallel paths differentiate through (mirrors
velocity_asr_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (data, model) mesh and lets XLA
insert the collectives. Here every device is a rank of a
``torch.distributed`` world (NCCL between CUDA devices, gloo between CPU
processes), and a ``Mesh`` holds this rank's place in the (data, model)
grid and the two process groups it belongs to: the ranks of its row (the
model axis: tensor, expert and pipeline parallelism) and of its column
(the data axis). The collectives are explicit, each an autograd Function
with the backward its place in the graph needs:

- ``enter``: identity forward, all-reduce backward. Computation after it
  is sharded (each rank computes a part), so each rank's cotangent is a
  part of the whole;
- ``reduce``: all-reduce forward, identity backward. It ends a sharded
  region whose outputs add up; what follows is computed on every rank;
- ``gather``: all-gather forward; the backward takes this rank's slice of
  the cotangent, or with ``sum_backward`` sums the cotangent over the
  ranks first (where what follows the gather differs from rank to rank).

A world-N training step equals the one-process step on the same global
batch when every random draw is made for the global tensor and each rank
takes its own part: ``data_shard`` marks this rank's rows of the global
batch for ``sharded_draw`` (and for the MoE load-balance loss, whose
fractions are global means).
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT = timedelta(minutes=10)  # a collective that waits longer fails


def init_distributed(device="cuda") -> torch.device:
    """Join the default process group, or build a one-rank one, and return
    this rank's device.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR`` in the environment) the group spans the launch;
    otherwise it is a world of one rank over an in-process store. A CUDA
    device means NCCL on ``cuda:LOCAL_RANK`` (an explicit index wins); the
    CPU means gloo. Asking for CUDA without a card raises: there is no
    silent CPU path. A second call returns the device and keeps the
    group."""
    device = resolve_device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1 or "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world,
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    return device


def shutdown_distributed() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main_process() -> bool:
    """Rank 0 of the world, or a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ----- layout ---------------------------------------------------------------------


def _default_slice_index(d) -> Optional[int]:
    return getattr(d, "slice_index", None)


def order_devices_hierarchical(devices: Sequence, slice_index_of=None) -> list:
    """Order devices slice-major (the JAX function's contract).

    A "slice" is a group of devices joined by the fast link: here the
    ranks of one node (NVLink), which torchrun numbers contiguously. Laid
    out slice-major, with a (slice, id) sort, a model axis no larger than
    a slice never crosses nodes, and the data axis's all-reduce spans
    slices on its outer stride. A list whose devices expose no slice
    comes back in the caller's order, as does one whose slices differ in
    size. slice_index_of overrides how a device's slice is read (the
    default: its ``slice_index`` attribute)."""
    slice_index_of = slice_index_of or _default_slice_index
    devices = list(devices)
    keyed = [(slice_index_of(d), d if isinstance(d, (int, np.integer)) else getattr(d, "id", i),
              d) for i, d in enumerate(devices)]
    if any(k[0] is None for k in keyed):
        return devices
    groups: dict = {}
    for s, i, d in keyed:
        groups.setdefault(s, []).append((i, d))
    if len({len(v) for v in groups.values()}) > 1:
        return devices
    out = []
    for s in sorted(groups):
        out.extend(d for _, d in sorted(groups[s], key=lambda e: e[0]))
    return out


def _rank_of(d) -> int:
    """A mesh entry is a rank, or an object whose ``id`` is its rank."""
    return d if isinstance(d, (int, np.integer)) else int(d.id)


class Mesh:
    """This rank's place in a (data, model) grid of ranks.

    ``shape`` maps each axis to its size, ``devices`` is the grid (the
    entries ``create_mesh`` was given), ``index(axis)`` this rank's
    coordinate in the grid (a group's own ranks, which order its
    gathers, follow the global ranks), ``group(axis)`` the process group
    of the ranks that share its other coordinate (None for an axis of
    size 1: nothing to communicate) and ``ranks(axis)`` their global ranks
    in order. A rank outside the grid has ``member`` False."""

    def __init__(self, grid: np.ndarray, groups: Dict, rank: int):
        self.devices = grid
        self.shape = {DATA_AXIS: grid.shape[0], MODEL_AXIS: grid.shape[1]}
        ranks = np.vectorize(_rank_of, otypes=[np.int64])(grid)
        self._ranks = ranks
        where = np.argwhere(ranks == rank)
        self.member = len(where) == 1
        self._coords = tuple(int(c) for c in where[0]) if self.member else (0, 0)
        self._groups = groups

    def index(self, axis: str) -> int:
        return self._coords[0 if axis == DATA_AXIS else 1]

    def ranks(self, axis: str) -> List[int]:
        i, j = self._coords
        line = self._ranks[:, j] if axis == DATA_AXIS else self._ranks[i, :]
        return [int(r) for r in line]

    def group(self, axis: str):
        return self._groups.get((axis, self._coords[1 if axis == DATA_AXIS else 0]))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, index=({self._coords}))"


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                devices: Optional[Sequence] = None, slice_index_of=None) -> Mesh:
    """A (data, model) mesh over the world's ranks (or `devices`: ranks,
    or objects whose ``id`` is a rank, as in a simulated layout).

    The ranks are ordered slice-major (``order_devices_hierarchical``; by
    default a rank's slice is its node, rank // LOCAL_WORLD_SIZE), so the
    model axis stays inside a node; n_data defaults to the ranks over
    n_model. Raises where the JAX function asserts: a grid larger than the
    ranks, and a model axis that would straddle slices. Every rank of the
    world must call it (group creation is collective)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is None:
        devices = list(range(world))
        if slice_index_of is None and world > 1:
            per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            slice_index_of = lambda r: r // per_node  # noqa: E731
    slice_of = slice_index_of or _default_slice_index
    devices = order_devices_hierarchical(devices, slice_index_of=slice_of)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {len(devices)} devices")
    slices = {slice_of(d) or 0 for d in devices}
    if n_model > 1 and len(slices) > 1:
        per_slice = len(devices) // len(slices)
        if per_slice % n_model:
            raise ValueError(
                f"model axis {n_model} would straddle DCN (per-slice device "
                f"count {per_slice}); choose n_model dividing the slice size")
    grid = np.empty((n_data, n_model), dtype=object)
    for k, d in enumerate(devices[: n_data * n_model]):
        grid[k // n_model, k % n_model] = d
    ranks = np.vectorize(_rank_of, otypes=[np.int64])(grid)
    if not dist.is_initialized():
        if ranks.size != 1:
            raise ValueError(f"a {n_data}x{n_model} mesh needs a process group of "
                             f"{ranks.size} ranks: call init_distributed under torchrun")
        return Mesh(grid, {}, int(ranks[0, 0]))
    # data groups: one per column, then model groups per row; an axis of
    # size 1 has none (every rank skips the same calls)
    groups = {}
    for j in range(n_model if n_data > 1 else 0):
        groups[(DATA_AXIS, j)] = dist.new_group([int(r) for r in ranks[:, j]], timeout=TIMEOUT)
    for i in range(n_data if n_model > 1 else 0):
        groups[(MODEL_AXIS, i)] = dist.new_group([int(r) for r in ranks[i, :]],
                                                 timeout=TIMEOUT)
    return Mesh(grid, groups, dist.get_rank())


def local_mesh() -> Mesh:
    """A 1 x 1 mesh of this rank alone, with no groups: the one-process
    computation inside a larger world (a reference to compare with)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = rank
    return Mesh(grid, {}, rank)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# ----- differentiable collectives --------------------------------------------------


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `t` over `group` in place, a sum unless `op` says otherwise
    (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


class _EnterAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in gs]), ctx.group)
        return (None,) + tuple(c.view_as(g) for c, g in zip(flat.split([g.numel() for g in gs]),
                                                           gs))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_backward):
        ctx.group, ctx.dim, ctx.sum_backward = group, dim, sum_backward
        ctx.size = x.shape[dim]
        return torch.cat(_all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_backward:
            g = all_reduce_(g.contiguous().clone(), ctx.group)
        lo = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size), None, None, None


def enter_all(tensors, group) -> tuple:
    """Identity forward, all-reduce backward (the start of a sharded
    region), of several tensors at once: their backward is one
    all-reduce, which cannot interleave differently on different ranks."""
    tensors = tuple(tensors)
    return tensors if group is None else _EnterAll.apply(group, *tensors)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """``enter_all`` of one tensor."""
    return enter_all((x,), group)[0]


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward (the end of a sharded region
    whose parts add up)."""
    return x if group is None else _Reduce.apply(x, group)


def gather(x: torch.Tensor, group, dim: int = 0, sum_backward: bool = False) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along `dim`, in rank
    order. The backward takes this rank's slice of the cotangent, or with
    sum_backward its slice of the cotangent summed over the ranks."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim % x.dim(), sum_backward)


# ----- this rank's rows of the global batch ------------------------------------------


@dataclass
class DataShard:
    """Rows [lo, hi) of a global batch padded to a multiple of the data
    axis by repeating row 0; rows at n_valid and past are the padding.
    `group` is the data axis's process group (None: one rank)."""

    n_valid: int
    lo: int
    hi: int
    group: object = None

    def row_mask(self, device) -> torch.Tensor:
        """(hi - lo,) bool: which of this rank's rows are real."""
        return torch.arange(self.lo, self.hi, device=device) < self.n_valid

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the data axis (no gradient)."""
        return all_reduce_(t.detach().clone(), self.group)


_DP_TLS = threading.local()


@contextlib.contextmanager
def data_shard(shard: Optional[DataShard]):
    """While active (per thread), ``sharded_draw`` draws for the global
    batch and the MoE load-balance loss sums over it; None suspends an
    outer shard (a pipeline stage's microbatches draw on their own)."""
    prev = getattr(_DP_TLS, "shard", None)
    _DP_TLS.shard = shard
    try:
        yield
    finally:
        _DP_TLS.shard = prev


def current_data_shard() -> Optional[DataShard]:
    return getattr(_DP_TLS, "shard", None)


def sharded_draw(draw: Callable, shape, batch_dim: int = 0, experts=None) -> torch.Tensor:
    """``draw(shape)`` as this rank's part of the draw a one-process run
    makes.

    Under ``data_shard``, dim `batch_dim` of `shape` holds this rank's
    rows (each row a fixed number of entries along it): the draw is made
    for the n_valid rows of the global batch and this rank's rows are
    taken, a padding row taking row 0's. `experts` = (index, count)
    marks dim 0 as this rank's block of experts, of `count` equal blocks:
    the draw is made for all of them and the block taken. The generator
    advances as the one-process draw advances it, on every rank."""
    shard = current_data_shard()
    if shard is None and experts is None:
        return draw(tuple(shape))
    gshape = list(shape)
    if shard is not None:
        local_rows = shard.hi - shard.lo
        if shape[batch_dim] % local_rows:
            raise ValueError(f"a draw of shape {tuple(shape)} does not hold {local_rows} rows "
                             f"along dim {batch_dim}")
        per_row = shape[batch_dim] // local_rows
        gshape[batch_dim] = shard.n_valid * per_row
    if experts is not None:
        gshape[0] = shape[0] * experts[1]
    full = draw(tuple(gshape))
    if experts is not None:
        full = full.narrow(0, experts[0] * shape[0], shape[0])
    if shard is not None:
        rows = torch.arange(shard.lo, shard.hi, device=full.device)
        rows = torch.where(rows < shard.n_valid, rows, torch.zeros_like(rows))
        idx = (rows[:, None] * per_row + torch.arange(per_row, device=full.device)).reshape(-1)
        full = full.index_select(batch_dim, idx)
    return full


def shard_batch(mesh: Mesh, batch: Dict) -> tuple:
    """(this rank's rows of `batch`, the global valid count, its
    ``DataShard``).

    The batch's arrays (``texts`` and other non-arrays are dropped) are
    padded to a multiple of the data axis by repeating row 0, as the JAX
    Trainer pads; data index i takes the i-th equal block of rows."""
    arrays = {k: np.asarray(v) for k, v in batch.items() if k != "texts" and hasattr(v, "ndim")}
    n_valid = next(iter(arrays.values())).shape[0]
    n_data = mesh.shape[DATA_AXIS]
    pad = (-n_valid) % n_data
    per = (n_valid + pad) // n_data
    lo = mesh.index(DATA_AXIS) * per
    out = {}
    for k, v in arrays.items():
        if pad:
            v = np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
        out[k] = v[lo:lo + per]
    return out, n_valid, DataShard(n_valid, lo, lo + per, mesh.group(DATA_AXIS))
