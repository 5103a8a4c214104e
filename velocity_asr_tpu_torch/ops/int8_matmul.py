"""Int8 dense for quantized inference (mirrors velocity_asr_tpu/ops/int8_matmul.py).

  - weights: per-output-channel symmetric int8 codes, kept in torch's
    Linear layout (N, K) with one fp32 scale per output channel (N,);
  - activations: a symmetric int8 scale per row of the flattened
    (tokens, features) input (dynamic), or one calibrated scale for the
    whole tensor (static);
  - int8 x int8 products summed in int32, dequantized by x_scale * w_scale.

``int8_dot_plain`` is the arithmetic of the JAX package's
``int8_dot_xla``, which is what it computes for every projection of the
synth checkpoint (its Pallas kernels run only for K and N multiples of
128 on a TPU). ``int8_dot`` launches ``csrc/int8_dense.cu`` on CUDA
tensors (fp32 or bf16 x, read as it is) and runs ``int8_dot_plain`` on
CPU tensors.
"""

from __future__ import annotations

import torch

from .cuda_lib import check_tensor, library

QMAX = 127.0
MIN_SCALE = 1e-10
# x's type code in the kernels' C entries: they read fp32 or bf16 x as it is
X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-10), the division IEEE on every device: CUDA
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which differs in the last bit."""
    qmax = torch.full((), QMAX, dtype=torch.float32, device=amax.device)
    return torch.clamp_min(amax.to(torch.float32) / qmax, MIN_SCALE)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 of a Linear weight (N, K).

    Returns (codes (N, K) int8, scale (N,) fp32): scale = max(amax / 127,
    1e-10) with amax over K (the flax kernel's axis 0), codes rounded half
    to even and clipped to [-127, 127], the JAX package's grid.
    """
    w = w.detach().to(torch.float32)
    scale = scale_of(w.abs().amax(dim=1))
    codes = torch.clamp(torch.round(w / scale[:, None]), -QMAX, QMAX).to(torch.int8)
    return codes, scale


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row activation scale (..., 1) fp32: max(amax / 127, 1e-10)."""
    return scale_of(x.to(torch.float32).abs().amax(dim=-1, keepdim=True))


def quantize_activation(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of x on the grid x_scale (per row or one scalar)."""
    q = torch.round(x.to(torch.float32) / x_scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def int8_dot_plain(x, w_q, w_scale, x_scale=None) -> torch.Tensor:
    """Plain version of the kernels: (..., K) float -> (..., N) fp32.

    x_scale None gives per-row dynamic scales, else one static scale (a
    fp32 tensor of one element). The int32 sum is taken in float64, which
    holds every such sum exactly (|sum| <= 127 * 127 * K < 2**53), so the
    same code runs on the CPU and on the card, where int32 matmuls are
    not available.
    """
    if x_scale is None:
        x_scale = dynamic_scale(x)
    else:
        x_scale = x_scale.to(torch.float32).reshape(())
    x_q = quantize_activation(x, x_scale)
    acc = torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64).T)
    return acc.to(torch.float32) * (x_scale * w_scale)


def _launch_int8(lib, x, w_q, w_scale, x_scale=None, codes_out=None) -> torch.Tensor:
    """Allocate the (M, N) fp32 output and launch ``int8_dense_dynamic_f32``
    (x_scale None) or ``int8_dense_static_f32`` on x as it is: its rows
    (..., K) flattened to M without a copy when x is contiguous, its type
    (fp32 or bf16, anything else raises) passed as a code. One kernel,
    counted once; none for an empty product."""
    if x.dtype not in X_TYPES:
        raise ValueError(f"the int8 kernels read fp32 or bf16 x, got {x.dtype}")
    k = x.shape[-1]
    n = w_q.shape[0]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m and n:
        codes_ptr = None if codes_out is None else codes_out.data_ptr()
        if x_scale is None:
            lib.launch("int8_dense_dynamic_f32", x2.data_ptr(), w_q.data_ptr(),
                       w_scale.data_ptr(), out.data_ptr(), codes_ptr, X_TYPES[x.dtype], m, k, n)
        else:
            lib.launch("int8_dense_static_f32", x2.data_ptr(), x_scale.data_ptr(),
                       w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(), codes_ptr,
                       X_TYPES[x.dtype], m, k, n)
    return out.reshape(*x.shape[:-1], n)


def int8_dot(x, w_q, w_scale, x_scale=None, codes_out=None) -> torch.Tensor:
    """Int8 dense of x (..., K) against codes w_q (N, K): (..., N) fp32.

    On CUDA tensors this launches ``int8_dense_dynamic_f32`` (x_scale
    None) or ``int8_dense_static_f32`` (x_scale a one-element fp32 device
    tensor, read by the kernel) on x in fp32 or bf16 as it is, at any K;
    on CPU tensors it runs ``int8_dot_plain``. codes_out, an int8 CUDA
    tensor of x's shape, receives the kernel's activation codes (for
    checks).
    """
    if not x.is_cuda:
        if codes_out is not None:
            raise ValueError("codes_out is for the CUDA kernels")
        return int8_dot_plain(x, w_q, w_scale, x_scale)
    k = x.shape[-1]
    n = w_q.shape[0]
    check_tensor(w_q, "w_q", (n, k), torch.int8)
    check_tensor(w_scale, "w_scale", (n,))
    tensors = [w_q, w_scale]
    if x_scale is not None:
        x_scale = x_scale.reshape(1)
        check_tensor(x_scale, "x_scale", (1,))
        tensors.append(x_scale)
    if codes_out is not None:
        check_tensor(codes_out, "codes_out", tuple(x.shape), torch.int8)
        tensors.append(codes_out)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"int8_dot operands on {t.device} and {x.device}")
    with torch.cuda.device(x.device):
        return _launch_int8(library(), x, w_q, w_scale, x_scale, codes_out)


def dynamic_int8_dense(x, w_q, w_scale, bias=None, x_scale=None) -> torch.Tensor:
    """Int8 Dense: the int8 product, the bias added in fp32, one cast to
    x's dtype (the JAX package's ``dynamic_int8_dense``)."""
    out = int8_dot(x, w_q, w_scale, x_scale)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)
