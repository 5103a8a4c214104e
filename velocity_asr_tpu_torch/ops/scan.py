"""Selective scan for the SSM core (mirrors velocity_asr_tpu/ops/scan.py).

    h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * B[t]) * x[t]
    y[t] = C[t] . h[t] + D * x[t]

with x, dt (batch, L, d_inner), A (state_dim,), B, C (batch, L, state_dim)
and D (d_inner,): the JAX package's layouts. A streaming chunk seeds
h[-1] from a carried state h0 and returns h[L-1]; both are (batch,
d_inner, state_dim) fp32, the JAX oracle's layout, whatever the compute
dtype (a bf16 carry would degrade every later chunk).

``selective_scan_sequential`` is the oracle. ``scan_fwd`` (h0 = 0) and
``scan_fwd_state`` (carried state) are the CUDA kernel
``csrc/scan_fwd.cu`` on a CUDA tensor and ``scan_fwd_plain``, a loop over
t, on a CPU tensor. ``scan_fwd_timeline`` runs the same kernel with a
per-phase clock timeline of one block, for measuring only.

Training: ``scan_fwd_bounds`` also returns the state entering every
chunk of ``TRAIN_CHUNK`` steps, (batch, ceil(L/16), d_inner, state_dim)
fp32 (the JAX kernel's (batch, chunks, N, d_inner), transposed to the
port's state layout), and ``scan_bwd`` recomputes each chunk's states
from them and runs the adjoint (``csrc/scan_fwd.cu`` and
``csrc/scan_bwd.cu`` on CUDA tensors, ``scan_fwd_bounds_plain`` and
``scan_bwd_plain`` on CPU tensors). ``SelectiveScanFn`` ties the two
together as an autograd Function; ``selective_scan`` takes it whenever
autograd records.

The streaming-aware objective differentiates the carried-state scan:
``scan_fwd_bounds_state`` runs the bounds forward from h0 (bounds[:, 0]
is h0) and also returns h_final, and ``scan_bwd_state`` starts the
adjoint from the cotangent gh of h_final and also returns dh0 (kernels
``scan_fwd_bounds_state_f32`` and ``scan_bwd_state_f32``; the same plain
versions with h0 and gh on CPU tensors). ``CarriedStateScanFn`` ties
them together; without autograd the streaming path keeps
``scan_fwd_state``, which stores no bounds. The raw wrappers refuse CUDA
inputs that require grad while autograd records: their kernels' outputs
carry no gradient.
"""

from __future__ import annotations

import torch

from .cuda_lib import check_tensor, library

TRAIN_CHUNK = 16  # steps between saved states (JAX ops/scan_pallas.py TRAIN_CHUNK)


def scan_fwd_plain(x, dt, A, B, C, h0=None, return_state: bool = False):
    """Plain version of the kernel: y[t] = C[t] . h[t], no D*x skip.

    h starts from h0 (batch, d_inner, state_dim), or 0; with return_state
    it returns (y, h_final)."""
    batch, length, d_inner = x.shape
    if h0 is None:
        h = torch.zeros(batch, d_inner, A.shape[0], dtype=x.dtype, device=x.device)
    else:
        h = h0
    ys = []
    for t in range(length):
        dA = torch.exp(dt[:, t, :, None] * A)  # (b, d, n)
        dBx = (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x)
    if return_state:
        return y, h.clone() if h is h0 else h
    return y


def scan_fwd_bounds_plain(x, dt, A, B, C, h0=None, return_state: bool = False):
    """Plain version of the training forward: (y, bounds), no D*x skip.
    h starts from h0 (batch, d_inner, state_dim), or 0. bounds[:, c] is
    the state entering step TRAIN_CHUNK * c (h0, or zeros, for c = 0),
    (batch, ceil(L/16), d_inner, state_dim), in x's dtype. With
    return_state it returns (y, bounds, h_final)."""
    batch, length, d_inner = x.shape
    if h0 is None:
        h = torch.zeros(batch, d_inner, A.shape[0], dtype=x.dtype, device=x.device)
    else:
        h = h0
    ys, bounds = [], []
    for t in range(length):
        if t % TRAIN_CHUNK == 0:
            bounds.append(h)
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    if not ys:
        out = torch.zeros_like(x), h.new_zeros(batch, 0, d_inner, A.shape[0])
    else:
        out = torch.stack(ys, dim=1), torch.stack(bounds, dim=1)
    if return_state:
        return out + (h.clone() if h is h0 else h,)
    return out


def scan_bwd_plain(x, dt, A, B, C, bounds, g, gh=None):
    """Plain version of the backward: (dx, ddt, dA, dB, dC) of the scan
    part (no D*x skip terms) for the cotangent g of y, written out as the
    kernel computes it: chunks in reverse, each chunk's states recomputed
    from its saved bound, then the adjoint

        lam[t] = C[t] g[t] + exp(dt[t+1] A) lam[t+1]

    over the chunk's steps in reverse, from lam[L] = gh, the cotangent of
    h_final (batch, d_inner, state_dim), or 0. With gh it also returns
    dh0 = exp(dt[0] A) lam[0], the cotangent of h0. Works in the inputs'
    dtype (fp32 or fp64)."""
    batch, length, d_inner = x.shape
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = torch.zeros_like(A)
    if gh is None:
        lam = torch.zeros(batch, d_inner, A.shape[0], dtype=x.dtype, device=x.device)
    else:
        lam = gh
    for c in reversed(range(bounds.shape[1])):
        t0, t1 = c * TRAIN_CHUNK, min(length, (c + 1) * TRAIN_CHUNK)
        hs = [bounds[:, c]]  # hs[i] = h[t0 + i - 1]
        decs = []
        for t in range(t0, t1):
            decs.append(torch.exp(dt[:, t, :, None] * A))
            hs.append(decs[-1] * hs[-1] + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :])
        for t in reversed(range(t0, t1)):
            i = t - t0
            lam = lam + C[:, t, None, :] * g[:, t, :, None]
            dd = lam * hs[i] * decs[i]  # dL/d(decay[t]) * decay[t]
            ds = (lam * B[:, t, None, :]).sum(-1)
            dx[:, t] = ds * dt[:, t]
            ddt[:, t] = (dd * A).sum(-1) + ds * x[:, t]
            dB[:, t] = (lam * (dt[:, t] * x[:, t])[..., None]).sum(1)
            dC[:, t] = (hs[i + 1] * g[:, t, :, None]).sum(1)
            dA = dA + (dd * dt[:, t, :, None]).sum((0, 1))
            lam = lam * decs[i]
    if gh is not None:
        return dx, ddt, dA, dB, dC, lam.clone() if lam is gh else lam
    return dx, ddt, dA, dB, dC


def _refuse_grad(*tensors) -> None:
    """A kernel's output has no grad_fn: refuse, rather than drop, a
    gradient autograd would expect through it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the scan kernels' outputs carry no gradient: call selective_scan "
            "(SelectiveScanFn) to differentiate through the scan")


def _check_state(h, name, x, state_dim):
    """h must be a (batch, d_inner, state_dim) fp32 state on x's device."""
    check_tensor(h, name, (x.shape[0], x.shape[2], state_dim))
    if h.device != x.device:
        raise ValueError(f"{name} is on {h.device}, x on {x.device}")


def _check_inputs(x, dt, A, B, C):
    batch, length, d_inner = x.shape
    state_dim = A.shape[0]
    for name, t, shape in (
        ("x", x, (batch, length, d_inner)),
        ("dt", dt, (batch, length, d_inner)),
        ("A", A, (state_dim,)),
        ("B", B, (batch, length, state_dim)),
        ("C", C, (batch, length, state_dim)),
    ):
        check_tensor(t, name, shape)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return batch, length, d_inner, state_dim


def scan_fwd(x, dt, A, B, C) -> torch.Tensor:
    """Selective-scan forward y (no D*x skip) in fp32, from h = 0.

    On CUDA tensors this launches ``scan_fwd_f32`` (any state_dim); on
    CPU tensors it runs ``scan_fwd_plain``.
    """
    if not x.is_cuda:
        return scan_fwd_plain(x, dt, A, B, C)
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    _refuse_grad(x, dt, A, B, C)
    y = torch.empty_like(x)
    if batch == 0 or length == 0:
        return y
    with torch.cuda.device(x.device):
        library().launch(
            "scan_fwd_f32", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(),
            batch, length, d_inner, state_dim,
        )
    return y


def scan_fwd_state(x, dt, A, B, C, h0):
    """Selective-scan forward seeded by h0: (y, h_final), fp32, no D*x skip.

    h0 and h_final are (batch, d_inner, state_dim). On CUDA tensors this
    launches ``scan_fwd_state_f32`` (any state_dim); on CPU tensors it
    runs ``scan_fwd_plain(..., h0, return_state=True)``. An empty chunk
    (L = 0) returns a copy of h0 without a launch.
    """
    if not x.is_cuda:
        return scan_fwd_plain(x, dt, A, B, C, h0, return_state=True)
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    _check_state(h0, "h0", x, state_dim)
    _refuse_grad(x, dt, A, B, C, h0)
    y = torch.empty_like(x)
    if batch == 0 or length == 0:
        return y, h0.clone()
    h_final = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        library().launch(
            "scan_fwd_state_f32", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_final.data_ptr(), batch, length, d_inner, state_dim,
        )
    return y, h_final


def scan_fwd_bounds(x, dt, A, B, C):
    """Training forward: (y, bounds), fp32, from h = 0, no D*x skip.

    On CUDA tensors this launches ``scan_fwd_bounds_f32`` (y bit-equal to
    ``scan_fwd_f32``'s); on CPU tensors it runs ``scan_fwd_bounds_plain``.
    """
    if not x.is_cuda:
        return scan_fwd_bounds_plain(x, dt, A, B, C)
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    _refuse_grad(x, dt, A, B, C)
    n_chunks = -(-length // TRAIN_CHUNK)
    y = torch.empty_like(x)
    bounds = torch.empty(batch, n_chunks, d_inner, state_dim, dtype=torch.float32,
                         device=x.device)
    if batch == 0 or length == 0:
        return y, bounds
    with torch.cuda.device(x.device):
        library().launch(
            "scan_fwd_bounds_f32", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), bounds.data_ptr(),
            batch, length, d_inner, state_dim,
        )
    return y, bounds


def scan_fwd_bounds_state(x, dt, A, B, C, h0):
    """Training forward of the carried-state scan: (y, bounds, h_final),
    fp32, seeded by h0, no D*x skip; bounds[:, 0] is h0.

    On CUDA tensors this launches ``scan_fwd_bounds_state_f32`` (y and
    h_final bit-equal to ``scan_fwd_state_f32``'s); on CPU tensors it runs
    ``scan_fwd_bounds_plain(..., h0, return_state=True)``. An empty chunk
    (L = 0) returns no bounds and a copy of h0 without a launch.
    """
    if not x.is_cuda:
        return scan_fwd_bounds_plain(x, dt, A, B, C, h0, return_state=True)
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    _check_state(h0, "h0", x, state_dim)
    _refuse_grad(x, dt, A, B, C, h0)
    y = torch.empty_like(x)
    bounds = torch.empty(batch, -(-length // TRAIN_CHUNK), d_inner, state_dim,
                         dtype=torch.float32, device=x.device)
    if batch == 0 or length == 0:
        return y, bounds, h0.clone()
    h_final = torch.empty_like(h0)
    with torch.cuda.device(x.device):
        library().launch(
            "scan_fwd_bounds_state_f32", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), h0.data_ptr(), y.data_ptr(), bounds.data_ptr(),
            h_final.data_ptr(), batch, length, d_inner, state_dim,
        )
    return y, bounds, h_final


# The stamps of the timeline entry, in the order block (0, 0)'s thread 0
# writes them: a phase is the time from the stamp before to its own
# ("setup": the kernel's or pass's start to a tile's start, including the
# load of A and h and the first tile's copies; "staging": waiting for the
# tile's copies and the block's barrier; "issue": the next tile's copies;
# "stores": the previous tile's y rows and this tile's bounds; "chain":
# the 16 steps; "reduction": y's sum over the states; "tail": the last
# rows and h_final).
TIMELINE_TILE_PHASES = ("setup", "staging", "issue", "stores", "chain", "reduction")
TIMELINE_PHASES = TIMELINE_TILE_PHASES + ("tail",)


def timeline_shares(clocks, length: int) -> dict:
    """Cycles of each phase in block (0, 0)'s timeline (``scan_fwd_timeline``)
    of a scan of `length` steps: {phase: (cycles, share of the total)},
    "total" (cycles from the kernel's start to its last stamp),
    "clock_ghz" (those cycles over the global timer's nanoseconds between
    the same two stamps: the SM clock they ran at) and "blocks": every
    block's span, from the first block's start to the last one's end
    ("span_us"), the median, least and most of a block's own time
    ("block_us"), the blocks that started after the first block ended
    ("late_blocks") and the most blocks one SM ran ("per_sm_max")."""
    clocks = [int(v) for v in clocks]
    n_blocks = clocks[0]
    records = [clocks[1 + 3 * i:4 + 3 * i] for i in range(n_blocks)]
    clocks = clocks[1 + 3 * n_blocks:]
    stamps = clocks[:-2]
    ns = clocks[-1] - clocks[-2]
    n_tiles = -(-length // TRAIN_CHUNK)
    per_pass = len(TIMELINE_TILE_PHASES) * n_tiles + 1
    if (len(stamps) - 1) % per_pass:
        raise ValueError(f"{len(stamps)} stamps do not fit {n_tiles} tiles a pass")
    names = (list(TIMELINE_TILE_PHASES) * n_tiles + ["tail"]) * ((len(stamps) - 1) // per_pass)
    cycles = dict.fromkeys(TIMELINE_PHASES, 0)
    for name, before, after in zip(names, stamps, stamps[1:]):
        cycles[name] += after - before
    total = stamps[-1] - stamps[0]
    out = {name: (n, n / total if total else 0.0) for name, n in cycles.items()}
    out["total"] = (total, 1.0)
    out["clock_ghz"] = total / ns if ns > 0 else 0.0
    starts = [r[1] for r in records]
    spans = sorted((r[2] - r[1]) / 1e3 for r in records)
    per_sm = {}
    for r in records:
        per_sm[r[0]] = per_sm.get(r[0], 0) + 1
    first_end = min(r[2] for r in records)
    out["blocks"] = {"count": n_blocks, "sms": len(per_sm), "per_sm_max": max(per_sm.values()),
                     "span_us": (max(r[2] for r in records) - min(starts)) / 1e3,
                     "block_us": (spans[len(spans) // 2], spans[0], spans[-1]),
                     "late_blocks": sum(s >= first_end for s in starts)}
    return out


def _launch_timeline(lib, x, dt, A, B, C, save_bounds: bool):
    """Allocate y, the bounds (with save_bounds) and the clock buffer the
    library asks for (its size passed too, which the C entry checks) and
    launch ``scan_fwd_timeline_f32`` once. Returns (y, bounds or None,
    clocks (int64))."""
    batch, length, d_inner = x.shape
    state_dim = A.shape[0]
    n_clocks = lib.lib.scan_fwd_timeline_clocks(batch, length, d_inner, state_dim)
    clocks = torch.zeros(n_clocks, dtype=torch.int64, device=x.device)
    y = torch.empty_like(x)
    bounds = (torch.empty(batch, -(-length // TRAIN_CHUNK), d_inner, state_dim,
                          dtype=torch.float32, device=x.device) if save_bounds else None)
    lib.launch("scan_fwd_timeline_f32", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
               B.data_ptr(), C.data_ptr(), y.data_ptr(),
               None if bounds is None else bounds.data_ptr(), clocks.data_ptr(), n_clocks,
               int(save_bounds), batch, length, d_inner, state_dim)
    return y, bounds, clocks


def scan_fwd_timeline(x, dt, A, B, C, save_bounds: bool = False):
    """``scan_fwd`` (or, with save_bounds, ``scan_fwd_bounds``) through the
    forward kernel's timeline instantiation: (y, bounds or None, clocks),
    where clocks (int64) are block (0, 0)'s clock64() stamps at its phase
    boundaries (``timeline_shares`` reads them). For measuring only: no
    path calls it. On CPU tensors it runs the plain version and returns
    no clocks. A non-empty scan only."""
    if not x.is_cuda:
        if save_bounds:
            return scan_fwd_bounds_plain(x, dt, A, B, C) + (None,)
        return scan_fwd_plain(x, dt, A, B, C), None, None
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    _refuse_grad(x, dt, A, B, C)
    if batch == 0 or length == 0:
        raise ValueError("the timeline needs a non-empty scan")
    with torch.cuda.device(x.device):
        return _launch_timeline(library(), x, dt, A, B, C, save_bounds)


def _launch_bwd(lib, x, dt, A, B, C, bounds, g, gh=None):
    """Allocate the backward's outputs and the workspace the library asks
    for (its size passed too, which the C entry checks; its last batch + 1
    words are the kernel's arrival counters, which the entry zeroes on the
    stream first) and launch ``scan_bwd_f32`` (``scan_bwd_state_f32`` with
    gh): one kernel, counted once. Returns (dx, ddt, dA, dB, dC) and, with
    gh, dh0."""
    batch, length, d_inner = x.shape
    state_dim = A.shape[0]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty_like(A)
    n_work = lib.lib.scan_bwd_workspace_floats(batch, length, d_inner, state_dim)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (x, dt, A, B, C, bounds, g)]
    if gh is None:
        lib.launch("scan_bwd_f32", *ptrs, dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
                   dB.data_ptr(), dC.data_ptr(), work.data_ptr(), n_work,
                   batch, length, d_inner, state_dim)
        return dx, ddt, dA, dB, dC
    dh0 = torch.empty_like(gh)
    lib.launch("scan_bwd_state_f32", *ptrs, gh.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
               dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dh0.data_ptr(), work.data_ptr(),
               n_work, batch, length, d_inner, state_dim)
    return dx, ddt, dA, dB, dC, dh0


def scan_bwd(x, dt, A, B, C, bounds, g):
    """Backward of the no-state scan: (dx, ddt, dA, dB, dC), fp32, no D*x
    skip terms, from the forward's inputs, its bounds and g = dLoss/dy.

    On CUDA tensors this launches ``scan_bwd_f32`` (one kernel, which
    also sums dB, dC and dA across its blocks, deterministic); on CPU
    tensors it runs ``scan_bwd_plain``.
    """
    if not x.is_cuda:
        return scan_bwd_plain(x, dt, A, B, C, bounds, g)
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    check_tensor(bounds, "bounds", (batch, -(-length // TRAIN_CHUNK), d_inner, state_dim))
    check_tensor(g, "g", (batch, length, d_inner))
    if batch == 0 or length == 0:
        return (torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(A),
                torch.zeros_like(B), torch.zeros_like(C))
    with torch.cuda.device(x.device):
        return _launch_bwd(library(), x, dt, A, B, C, bounds, g)


def scan_bwd_state(x, dt, A, B, C, bounds, g, gh):
    """Backward of the carried-state scan: (dx, ddt, dA, dB, dC, dh0),
    fp32, no D*x skip terms, from the forward's inputs, its bounds
    (``scan_fwd_bounds_state``), g = dLoss/dy and gh = dLoss/dh_final
    (batch, d_inner, state_dim).

    On CUDA tensors this launches ``scan_bwd_state_f32`` (one kernel, as
    ``scan_bwd_f32``); on CPU tensors it runs ``scan_bwd_plain(...,
    gh)``. An empty chunk (L = 0) passes gh through as dh0.
    """
    if not x.is_cuda:
        return scan_bwd_plain(x, dt, A, B, C, bounds, g, gh)
    batch, length, d_inner, state_dim = _check_inputs(x, dt, A, B, C)
    check_tensor(bounds, "bounds", (batch, -(-length // TRAIN_CHUNK), d_inner, state_dim))
    check_tensor(g, "g", (batch, length, d_inner))
    _check_state(gh, "gh", x, state_dim)
    if batch == 0 or length == 0:
        return (torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(A),
                torch.zeros_like(B), torch.zeros_like(C), gh.clone())
    with torch.cuda.device(x.device):
        return _launch_bwd(library(), x, dt, A, B, C, bounds, g, gh)


class SelectiveScanFn(torch.autograd.Function):
    """y = scan(x, dt, A, B, C) from h = 0 (no D*x skip), differentiable:
    the forward saves its inputs and the chunk-entry states
    (``scan_fwd_bounds``), the backward returns dx, ddt, dA, dB and dC
    (``scan_bwd``). fp32 contiguous inputs, all on one device."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C):
        y, bounds = scan_fwd_bounds(x, dt, A, B, C)
        ctx.save_for_backward(x, dt, A, B, C, bounds)
        return y

    @staticmethod
    def backward(ctx, g):
        return scan_bwd(*ctx.saved_tensors, g.contiguous())


class CarriedStateScanFn(torch.autograd.Function):
    """(y, h_final) = scan from h0 (no D*x skip), differentiable: the
    forward saves its inputs and the chunk-entry states
    (``scan_fwd_bounds_state``), the backward returns dx, ddt, dA, dB, dC
    and dh0 (``scan_bwd_state``) from the cotangents of y and h_final
    (zeros where an output is unused). fp32 contiguous inputs, all on one
    device."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        y, bounds, h_final = scan_fwd_bounds_state(x, dt, A, B, C, h0)
        ctx.save_for_backward(x, dt, A, B, C, bounds)
        return y, h_final

    @staticmethod
    def backward(ctx, gy, gh):
        return scan_bwd_state(*ctx.saved_tensors, gy.contiguous(), gh.contiguous())


def selective_scan_sequential(x, dt, A, B, C, D, h0=None, return_state: bool = False):
    """The oracle: a plain loop over time, plus the D*x skip."""
    out = scan_fwd_plain(x, dt, A, B, C, h0, return_state)
    if return_state:
        return out[0] + x * D, out[1]
    return out + x * D


def selective_scan(x, dt, A, B, C, D, mode: str = "parallel", h0=None,
                   return_state: bool = False):
    """Dispatch on the scan mode.

    "sequential" is the oracle. "pallas" (the committed checkpoints' mode)
    and "parallel" (the JAX default) both take the kernel path: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors. The D*x
    skip is added outside the kernel, as on the TPU. With h0 or
    return_state the scan runs the carried-state kernel (h0 = 0 where none
    is given), as the JAX package's Pallas tier does; the state returned
    is fp32 (batch, d_inner, state_dim).

    While autograd records and an input (h0 included) requires grad, the
    scan goes through ``SelectiveScanFn``, or ``CarriedStateScanFn`` with
    h0 or return_state (the training kernels on CUDA tensors, their plain
    versions on CPU tensors), so the gradient reaches h0 and flows from
    h_final.
    """
    if mode == "sequential":
        return selective_scan_sequential(x, dt, A, B, C, D, h0, return_state)
    if mode not in ("pallas", "parallel"):
        raise ValueError(f"Unknown scan mode: {mode!r}")
    args = [t.contiguous() for t in (x, dt, A, B, C)]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, h0)
                                           if t is not None)
    if h0 is None and not return_state:
        return (SelectiveScanFn.apply(*args) if grad else scan_fwd(*args)) + x * D
    if h0 is None:
        h0 = torch.zeros(x.shape[0], x.shape[2], A.shape[0], dtype=torch.float32,
                         device=x.device)
    h0 = h0.to(torch.float32).contiguous()
    y, h_final = (CarriedStateScanFn.apply(*args, h0) if grad
                  else scan_fwd_state(*args, h0))
    y = y + x * D
    return (y, h_final) if return_state else y
