"""Sequence-parallel selective scan (mirrors
velocity_asr_tpu/parallel/sp_scan.py).

The time axis of a scan is split over the ranks of one mesh axis. The
recurrence h[t] = a[t] h[t-1] + b[t] is associative, and a shard's
effect on what follows it is its pair (a_last, h_last): the product of
its decays, exp(A * sum of its dt), and the state it ends in from h = 0.
So each rank, holding the whole (replicated) input:

  1. takes its time shard and runs the carried-state scan kernel on it
     from h = 0 (``scan_fwd_state``), for h_last, and computes a_last in
     fp32;
  2. all-gathers the (a_last, h_last) pairs over the axis and combines
     those of the ranks before it into its incoming state h_in;
  3. runs the shard again through the same kernel, seeded with h_in, and
     all-gathers y back to the whole length.

That is what the JAX function computes (it corrects each shard's
zero-state scan by A_cum[t] * h_in) without its (batch, L, d_inner, N)
decay and input tensors: at the long form, (1, 3,600, 384, 64), each of
those is 354 MB, where the summaries here are (batch, d_inner, N). A scan
costs two kernel launches a rank.

Under autograd both passes run through ``CarriedStateScanFn``, the
summary gather's backward sums each summary's cotangent over the ranks
(each rank's h_in depends on the summaries before it), y's gather takes
this rank's slice, and the replicated inputs enter through an identity
whose backward sums each rank's part of their gradient.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.scan import CarriedStateScanFn, scan_fwd_state
from .mesh import DATA_AXIS, Mesh, enter_all, gather, group_rank, group_size

# The ambient context that ops.scan.selective_scan reads in mode "sp";
# thread-local, so a thread running outside the with-block (a server
# worker) sees none and raises rather than sharding over another thread's
# mesh.
_SP_TLS = threading.local()


@contextlib.contextmanager
def sequence_parallel(mesh: Mesh, axis: str = DATA_AXIS):
    """Route every ``scan_mode="sp"`` selective scan through the
    time-sharded scan over `axis` of `mesh` while active (per thread)."""
    prev = getattr(_SP_TLS, "ctx", None)
    _SP_TLS.ctx = (mesh, axis)
    try:
        yield
    finally:
        _SP_TLS.ctx = prev


def current_sequence_parallel() -> Optional[Tuple[Mesh, str]]:
    """The active (mesh, axis) set by ``sequence_parallel``, or None."""
    return getattr(_SP_TLS, "ctx", None)


def shard_summary(x, dt, A, B, C):
    """Pass 1 on one time shard: (a_last, h_last), each (batch, d_inner,
    N) fp32: the shard's decay product exp(A * sum_t dt) and the state it
    ends in from h = 0 (the carried-state kernel, its y unused)."""
    h0 = torch.zeros(x.shape[0], x.shape[2], A.shape[0], dtype=torch.float32, device=x.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
        _, h_last = CarriedStateScanFn.apply(x, dt, A, B, C, h0)
    else:
        _, h_last = scan_fwd_state(x, dt, A, B, C, h0)
    a_last = torch.exp(dt.sum(dim=1)[..., None] * A)
    return a_last, h_last


def incoming_state(a_all: torch.Tensor, h_all: torch.Tensor, index: int) -> torch.Tensor:
    """The state entering shard `index`: the summaries (a_all, h_all),
    (shards, batch, d_inner, N) each, of the shards before it combined in
    order, h <- a_i h + h_i from h = 0. Every summary enters the
    expression (those from `index` on with weight 0), so every rank's
    backward reaches the gather: its collective runs on all of them."""
    h_in = torch.zeros_like(h_all[0])
    for i in range(a_all.shape[0]):
        h_in = torch.where(torch.tensor(i < index), a_all[i] * h_in + h_all[i], h_in)
    return h_in


def shard_output(x, dt, A, B, C, D, h_in) -> torch.Tensor:
    """Pass 2 on one time shard: y from the carried-state kernel seeded
    with h_in, plus the D*x skip."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, h_in)):
        y, _ = CarriedStateScanFn.apply(x, dt, A, B, C, h_in)
    else:
        y, _ = scan_fwd_state(x, dt, A, B, C, h_in)
    return y + x * D


def selective_scan_sequence_parallel(x, dt, A, B, C, D, mesh: Mesh,
                                     axis: str = DATA_AXIS) -> torch.Tensor:
    """Selective scan with the time axis sharded over `axis` of `mesh`.

    Arguments as ``ops.scan.selective_scan_sequential``'s, the same on
    every rank of the axis; L must divide by the axis size. Returns the
    whole y on every rank. Exact: the shards' carried states reproduce
    the full-length recurrence (up to fp32 rounding)."""
    group = mesh.group(axis)
    n_shards, index = group_size(group), group_rank(group)
    length = x.shape[1]
    if length % n_shards:
        raise ValueError(f"the scan's {length} steps do not divide over {n_shards} ranks")
    x, dt, A, B, C, D = enter_all((x, dt, A, B, C, D), group)
    step = length // n_shards
    lo = index * step
    x_s, dt_s, B_s, C_s = (t[:, lo:lo + step].to(torch.float32).contiguous()
                           for t in (x, dt, B, C))
    A = A.to(torch.float32).contiguous()
    a_last, h_last = shard_summary(x_s, dt_s, A, B_s, C_s)
    summaries = gather(torch.stack([a_last, h_last])[None], group, dim=0, sum_backward=True)
    h_in = incoming_state(summaries[:, 0], summaries[:, 1], index)
    y_s = shard_output(x_s, dt_s, A, B_s, C_s, D, h_in)
    return gather(y_s, group, dim=1)


def selective_scan_sp_padded(x, dt, A, B, C, D, mesh: Mesh, axis: str = DATA_AXIS):
    """``selective_scan_sequence_parallel`` for any L: the time axis is
    padded to a multiple of the axis size with identity steps (dt = 0:
    decay exp(0) = 1 and no input, the state passes through) and the
    padding cut off y."""
    n_shards = group_size(mesh.group(axis))
    length = x.shape[1]
    pad = (-length) % n_shards
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x, dt, B, C))
    y = selective_scan_sequence_parallel(x, dt, A, B, C, D, mesh, axis)
    return y[:, :length] if pad else y
