"""Selective scan for the SSM core (mirrors velocity_asr_tpu/ops/scan.py).

    h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * B[t]) * x[t]
    y[t] = C[t] . h[t] + D * x[t]

with x, dt (batch, L, d_inner), A (state_dim,), B, C (batch, L, state_dim)
and D (d_inner,): the JAX package's layouts. ``selective_scan_sequential``
is the oracle; ``scan_fwd`` is the CUDA kernel ``csrc/scan_fwd.cu`` on a
CUDA tensor and ``scan_fwd_plain``, a loop over t, on a CPU tensor.
"""

from __future__ import annotations

import torch

from .cuda_lib import check_tensor, library


def scan_fwd_plain(x, dt, A, B, C) -> torch.Tensor:
    """Plain version of the kernel: y[t] = C[t] . h[t], no D*x skip."""
    batch, length, d_inner = x.shape
    h = torch.zeros(batch, d_inner, A.shape[0], dtype=x.dtype, device=x.device)
    ys = []
    for t in range(length):
        dA = torch.exp(dt[:, t, :, None] * A)  # (b, d, n)
        dBx = (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    if not ys:
        return torch.zeros_like(x)
    return torch.stack(ys, dim=1)


def scan_fwd(x, dt, A, B, C) -> torch.Tensor:
    """Selective-scan forward y (no D*x skip) in fp32.

    On CUDA tensors this launches ``scan_fwd_f32`` (any state_dim); on
    CPU tensors it runs ``scan_fwd_plain``.
    """
    if not x.is_cuda:
        return scan_fwd_plain(x, dt, A, B, C)
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


def selective_scan_sequential(x, dt, A, B, C, D) -> torch.Tensor:
    """The oracle: a plain loop over time, plus the D*x skip."""
    return scan_fwd_plain(x, dt, A, B, C) + x * D


def selective_scan(x, dt, A, B, C, D, mode: str = "parallel") -> torch.Tensor:
    """Dispatch on the scan mode.

    "sequential" is the oracle. "pallas" (the committed checkpoints' mode)
    and "parallel" (the JAX default) both take the kernel path: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors. The D*x
    skip is added outside the kernel, as on the TPU.
    """
    if mode == "sequential":
        return selective_scan_sequential(x, dt, A, B, C, D)
    if mode in ("pallas", "parallel"):
        return scan_fwd(x.contiguous(), dt.contiguous(), A.contiguous(),
                        B.contiguous(), C.contiguous()) + x * D
    raise ValueError(f"Unknown scan mode: {mode!r}")
