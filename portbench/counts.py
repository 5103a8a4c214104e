"""The yardstick's arithmetic: peaks of the card, and the operations,
bytes and model FLOPs of the work, counted from shapes alone.

These are frozen copies: a change to the program cannot move them. A
kernel's least time is the larger of its operations over the fp32 peak
(outside the tensor cores) and its bytes over the memory bandwidth, with
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

F32 = 4
SCAN_FWD_OPS = 7   # per (b, t, d, n): dt*A, exp, decay*h, (dt*x)*B, +, C*h, sum
# and one per (b, t, d): dt*x
SCAN_BWD_OPS = 20  # per (b, t, d, n): the recomputed states and the adjoint
TRAIN_CHUNK = 16   # steps between the states the training forward saves

HOP = 160
N_MELS = 80


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def scan_fwd_ops(b: int, length: int, d: int, n: int) -> int:
    return SCAN_FWD_OPS * b * length * d * n + b * length * d


def scan_fwd_bytes(b: int, length: int, d: int, n: int) -> int:
    """x and dt in, B and C in, A in, y out (fp32)."""
    return F32 * (3 * b * length * d + 2 * b * length * n + n)


def scan_fwd_bounds_bytes(b: int, length: int, d: int, n: int) -> int:
    """The training forward also writes the state entering every chunk."""
    chunks = -(-length // TRAIN_CHUNK)
    return scan_fwd_bytes(b, length, d, n) + F32 * b * chunks * d * n


def scan_bwd_ops(b: int, length: int, d: int, n: int) -> int:
    return SCAN_BWD_OPS * b * length * d * n


def scan_bwd_bytes(b: int, length: int, d: int, n: int) -> int:
    """x, dt, g in and dx, ddt out; B, C in and dB, dC out; A in, dA out;
    the saved chunk states in."""
    chunks = -(-length // TRAIN_CHUNK)
    return F32 * (5 * b * length * d + 4 * b * length * n + 2 * n + b * chunks * d * n)


def scan_fwd_seconds(b, length, d, n) -> float:
    return least_seconds(scan_fwd_ops(b, length, d, n), scan_fwd_bytes(b, length, d, n))


def scan_fwd_bounds_seconds(b, length, d, n) -> float:
    return least_seconds(scan_fwd_ops(b, length, d, n), scan_fwd_bounds_bytes(b, length, d, n))


def scan_bwd_seconds(b, length, d, n) -> float:
    return least_seconds(scan_bwd_ops(b, length, d, n), scan_bwd_bytes(b, length, d, n))


def log_mel_ops(b: int, frames: int) -> int:
    """A 400-point real FFT a frame as a 200-point complex FFT (about
    5 N log2 N real operations), its power, the 80 sparse bands and the
    log: small beside the bytes."""
    n = 200
    return b * frames * int(5 * n * math.log2(n) + 4 * 201 + 2 * 402 + N_MELS)


def log_mel_bytes(b: int, frames: int) -> int:
    """The front end's least traffic: the int16 PCM of the padded
    utterance read once ((frames - 1) * hop samples) and the fp32 mel
    written once."""
    return b * (2 * (frames - 1) * HOP + F32 * frames * N_MELS)


def log_mel_seconds(b, frames) -> float:
    return least_seconds(log_mel_ops(b, frames), log_mel_bytes(b, frames))


# ----- the model's shapes ---------------------------------------------------


def pool_sizes(length: int):
    """(K1, K2): the global context's two pool sizes at L local frames."""
    k1 = min(max(64, length // 8), length)
    k2 = min(min(64, max(16, k1 // 4)), k1)
    return k1, k2


def scan_shapes(model: dict, b: int, mel_frames: int):
    """Every scan a forward of (b, mel_frames) runs: [(b, L, d_inner, N)],
    the local blocks' then the global blocks'."""
    length = (mel_frames + 1) // 2
    k1, _ = pool_sizes(length)
    d_inner = model["d_model"] * model["ssm_expand_ratio"]
    local = [(b, length, d_inner, model["ssm_state_dim"])] * model["ssm_layers"]
    glob = [(b, k1, 2 * model["d_model"], model["global_ssm_state_dim"])] * \
        model["global_ssm_layers"]
    return local + glob


def _block_macs(d: int, d_inner: int, n: int, kernel: int, ffn_macs: int) -> int:
    """Multiply-adds a token of one SSM block: in_proj, x_proj, dt_proj,
    out_proj, the depthwise conv and the FFN."""
    return (d * 2 * d_inner + d_inner * 2 * n + d_inner * d_inner + d_inner * d
            + d * kernel + ffn_macs)


def forward_flops(model: dict, mel_frames: int) -> float:
    """Model FLOPs of one row's forward at mel_frames (padded) frames:
    2 x the multiply-adds of every Dense, convolution and attention
    product, plus the scans' operations. A routed FFN counts its top-k
    experts and its router. The pooling matmuls average and count
    nothing."""
    d = model["d_model"]
    d_inner = d * model["ssm_expand_ratio"]
    length = (mel_frames + 1) // 2
    k1, k2 = pool_sizes(length)
    hidden = d * model["ssm_expand_ratio"]
    experts = model.get("moe_experts", 0)
    if experts > 0:
        ffn = model["moe_top_k"] * 2 * d * hidden + d * experts
    else:
        ffn = 2 * d * hidden
    local = _block_macs(d, d_inner, model["ssm_state_dim"], model["ssm_kernel_size"], ffn)
    glob = _block_macs(d, 2 * d, model["global_ssm_state_dim"], 4, 2 * d * 2 * d)
    att = model["attention_dim"]
    macs = length * (3 * model["mel_bins"] * d)          # temporal binding conv
    macs += length * model["ssm_layers"] * local
    macs += k1 * d * d                                    # pool 1 projection
    macs += k1 * model["global_ssm_layers"] * glob
    macs += k2 * d * d                                    # pool 2 projection
    macs += length * d * att + 2 * k2 * d * att           # q, k, v projections
    macs += 2 * length * k2 * att                         # scores and attn @ v
    macs += length * att * d                              # attention out
    macs += length * (2 * d * d + 3 * d * d)              # gated fusion
    macs += length * d * model["vocab_size"]              # CTC head
    scan = (model["ssm_layers"] * scan_fwd_ops(1, length, d_inner, model["ssm_state_dim"])
            + model["global_ssm_layers"] * scan_fwd_ops(1, k1, 2 * d,
                                                        model["global_ssm_state_dim"]))
    return 2.0 * macs + scan


def train_flops(model: dict, mel_frames: int) -> float:
    """A training row: 3 x its forward (recompute excluded)."""
    return 3.0 * forward_flops(model, mel_frames)


def step_mfu(trace) -> float:
    """The whole step's share of the bf16 peak in a profiled slice: the
    model FLOPs of the valid frames its calls processed (a row's FLOPs at
    its padded length, scaled by its valid share; training rows count 3
    forwards), over the slice's wall seconds times the peak."""
    per_row = train_flops if trace.kind == "train" else forward_flops
    flops = 0.0
    for call in trace.calls:
        full = (call["frames"] + 1) // 2
        row = per_row(trace.model, call["frames"])
        for n in call["rows"]:
            flops += row * ((1 + n // HOP + 1) // 2) / full
    return 100.0 * flops / (trace.window_s * PEAK_BF16_FLOPS)
