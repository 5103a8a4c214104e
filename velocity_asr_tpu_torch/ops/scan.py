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
t, on a CPU tensor.
"""

from __future__ import annotations

import torch

from .cuda_lib import check_tensor, library


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
    check_tensor(h0, "h0", (batch, d_inner, state_dim))
    if h0.device != x.device:
        raise ValueError(f"h0 is on {h0.device}, x on {x.device}")
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
    """
    if mode == "sequential":
        return selective_scan_sequential(x, dt, A, B, C, D, h0, return_state)
    if mode not in ("pallas", "parallel"):
        raise ValueError(f"Unknown scan mode: {mode!r}")
    args = [t.contiguous() for t in (x, dt, A, B, C)]
    if h0 is None and not return_state:
        return scan_fwd(*args) + x * D
    if h0 is None:
        h0 = torch.zeros(x.shape[0], x.shape[2], A.shape[0], dtype=torch.float32,
                         device=x.device)
    y, h_final = scan_fwd_state(*args, h0.to(torch.float32).contiguous())
    y = y + x * D
    return (y, h_final) if return_state else y
