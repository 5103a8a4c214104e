"""Parity of the port's int8 dense (ops/int8_matmul.py, quantize.py) with
the JAX package's, on the same numpy weights and inputs.

Tolerances:
  - weight codes and scales: bit-exact (the same fp32 divisions and
    round-half-to-even on both sides);
  - ``int8_dot_plain`` against ``int8_dot_xla``, dynamic and static, K
    up to 1,536: rtol 1e-6 (the same codes, int32 sums and fp32
    dequantization);
  - against ``int8_dot_pallas`` in interpret mode at K = N = 128: the
    Pallas kernels take amax * (1/127) and x * (1/scale) where the port
    divides, so at most 0.1% of the activation codes differ (by one),
    and each output within one quantization step per differing code of
    its row (x_scale * w_scale * 127) plus 1e-6 of max|out|;
  - ``DynamicInt8Dense`` (dynamic, static calibrated, static not
    calibrated) against the flax module: rtol 1e-6 in fp32, and exact
    in bf16 (one cast of the same fp32 result).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import quantize as jquant
from velocity_asr_tpu.ops import int8_matmul as jint8
from velocity_asr_tpu_torch import quantize as tquant
from velocity_asr_tpu_torch.ops import cuda_lib
from velocity_asr_tpu_torch.ops import int8_matmul as tint8

RTOL = 1e-6


def _weights(seed, k, n, zero_col=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * rng.uniform(0.01, 1.0, (1, n))).astype(np.float32)
    if zero_col:
        w[:, 0] = 0.0  # an all-zero channel takes the 1e-10 floor
    return w  # flax layout (K, N)


def _x(seed, *shape, loud=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if loud:
        x = x * rng.uniform(0.1, 5.0, shape[:-1] + (1,))
    return x.astype(np.float32)


def _port_codes(w):
    return tint8.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))


@pytest.mark.parametrize("k,n", [(192, 48), (48, 192), (384, 30), (7, 5)])
def test_quantize_weight_bit_exact(k, n):
    w = _weights(k + n, k, n, zero_col=True)
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    tq, ts = _port_codes(w)
    assert tq.dtype == torch.int8 and tq.shape == (n, k) and ts.shape == (n,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])
    assert ts[0].item() == np.float32(1e-10)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k,n", [(192, 48), (384, 192), (50, 30), (1024, 70), (1536, 192)])
def test_int8_dot_plain_matches_xla(static, k, n):
    w = _weights(k, k, n)
    x = _x(n, 3, 17, k)
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    tq, ts = _port_codes(w)
    scale = np.float32(np.abs(x).max() / 127.0 * 0.7) if static else None  # clips the loudest
    ref = jint8.int8_dot_xla(jnp.asarray(x), jq, js,
                             x_scale=None if scale is None else jnp.asarray(scale))
    out = tint8.int8_dot_plain(torch.from_numpy(x), tq, ts,
                               None if scale is None else torch.tensor(scale))
    assert out.dtype == torch.float32 and out.shape == (3, 17, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=0)
    # int8_dot on CPU tensors is the plain version and launches nothing
    before = dict(cuda_lib.launch_counts)
    same = tint8.int8_dot(torch.from_numpy(x), tq, ts,
                          None if scale is None else torch.tensor(scale))
    torch.testing.assert_close(same, out, rtol=0, atol=0)
    assert dict(cuda_lib.launch_counts) == before


@pytest.mark.parametrize("static", [False, True])
def test_int8_dot_matches_pallas_interpret(static):
    k = n = 128
    w = _weights(11, k, n)
    x = _x(12, 3, 40, k)
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    tq, ts = _port_codes(w)
    xf = x.reshape(-1, k)
    if static:
        scale = np.float32(np.abs(x).max() / 127.0)
        ref = jint8.int8_dot_pallas(jnp.asarray(x), jq, js, x_scale=jnp.asarray(scale))
        xs_port = np.full((xf.shape[0], 1), scale, np.float32)
        pallas_codes = np.clip(np.round(xf * (np.float32(1) / scale)), -127, 127)
        out = tint8.int8_dot(torch.from_numpy(x), tq, ts, torch.tensor(scale))
    else:
        ref = jint8.int8_dot_pallas(jnp.asarray(x), jq, js)
        amax = np.abs(xf).max(axis=1, keepdims=True)
        xs_pallas = np.maximum(amax * np.float32(1.0 / 127.0), np.float32(1e-10))
        pallas_codes = np.clip(np.round(xf / xs_pallas), -127, 127)
        xs_port = tint8.dynamic_scale(torch.from_numpy(xf)).numpy()
        out = tint8.int8_dot(torch.from_numpy(x), tq, ts)
    port_codes = tint8.quantize_activation(torch.from_numpy(xf), torch.from_numpy(xs_port))
    flips = (port_codes.numpy() != pallas_codes)
    assert flips.mean() <= 1e-3
    assert np.abs(port_codes.numpy() - pallas_codes).max() <= 1
    out, ref = out.numpy().reshape(-1, n), np.asarray(ref).reshape(-1, n)
    step = xs_port * np.asarray(js) * 127.0  # one code of a row against the largest weight code
    bound = flips.sum(axis=1, keepdims=True) * step + 1e-6 * np.abs(ref).max()
    assert (np.abs(out - ref) <= bound).all()


def _flax_dense(features, static, dtype=jnp.float32):
    return jquant.DynamicInt8Dense(features, static=static, dtype=dtype)


def _port_dense(w, b, static, dtype=torch.float32):
    k, n = w.shape
    layer = tquant.DynamicInt8Dense(k, n, dtype=dtype, static=static)
    layer.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(w.T)),
                           "bias": torch.from_numpy(b)})
    return layer.requires_grad_(False).eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_int8_dense_layer_matches_flax(dtype):
    k, n = 96, 40
    w, b = _weights(1, k, n), _x(2, n, loud=False)
    x = _x(3, 2, 9, k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    ref = _flax_dense(n, False, jdt).apply({"params": params}, jnp.asarray(x, jdt))
    out = _port_dense(w, b, False, tdt)(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_int8_dense_layer_matches_flax(dtype):
    """Calibrated on two batches (running max-abs), and before any
    calibration (one per-tensor dynamic scale through the static path)."""
    k, n = 64, 24
    w, b = _weights(4, k, n), _x(5, n, loud=False)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    calib = [_x(6, 3, 10, k), 2.0 * _x(7, 3, 10, k)]
    x = 3.0 * _x(8, 2, 10, k)  # louder than calibration: the static scale clips
    module = _flax_dense(n, True, jdt)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt))
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    stats0 = variables["quant_stats"]
    port = _port_dense(w, b, True, tdt)

    ref_uncal = module.apply({"params": params, "quant_stats": stats0}, jnp.asarray(x, jdt))
    out_uncal = port(torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(out_uncal.float().numpy(), np.asarray(ref_uncal, np.float32),
                               rtol=RTOL, atol=0)
    # the fallback is one scale for the whole tensor, not one per row
    per_tensor = tint8.int8_dot_plain(torch.from_numpy(x).to(tdt), port.w_q, port.w_scale,
                                      tint8.scale_of(torch.from_numpy(x).to(tdt).float()
                                                     .abs().amax()))
    torch.testing.assert_close(out_uncal.float(), (per_tensor + port.bias).to(tdt).float())

    stats = stats0
    for c in calib:
        _, mutated = module.apply({"params": params, "quant_stats": stats},
                                  jnp.asarray(c, jdt), mutable=["quant_stats"])
        stats = mutated["quant_stats"]
    stats = jquant.mark_calibrated(stats)
    tquant.calibrate_int8_model(port, [torch.from_numpy(c).to(tdt) for c in calib])
    assert port.x_amax.item() == float(stats["x_amax"])
    assert bool(port.calibrated) and bool(stats["calibrated"])
    ref = module.apply({"params": params, "quant_stats": stats}, jnp.asarray(x, jdt))
    out = port(torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=RTOL,
                               atol=0)
    assert not torch.allclose(out.float(), out_uncal.float())


def test_calibration_pass_is_the_plain_dense_and_accumulates_max():
    k, n = 32, 16
    w, b = _weights(9, k, n), _x(10, n, loud=False)
    port = _port_dense(w, b, True)
    x = torch.from_numpy(_x(11, 4, k))
    port.calibrating = True
    y = port(x)
    torch.testing.assert_close(y, x @ torch.from_numpy(w) + torch.from_numpy(b))
    port(3 * x)
    port.calibrating = False
    assert port.x_amax.item() == pytest.approx(3 * x.abs().max().item(), rel=1e-6)
    assert not bool(port.calibrated)
    tquant.mark_calibrated(port)
    assert bool(port.calibrated)


def test_per_row_scales_ignore_a_loud_batchmate():
    k, n = 80, 20
    w, b = _weights(13, k, n), _x(14, n, loud=False)
    port = _port_dense(w, b, False)
    quiet = torch.from_numpy(_x(15, 1, 6, k, loud=False))
    loud = 1000.0 * torch.from_numpy(_x(16, 1, 6, k, loud=False))
    alone = port(quiet)
    together = port(torch.cat([quiet, loud], dim=0))
    torch.testing.assert_close(together[:1], alone, rtol=0, atol=0)


def test_weight_codes_follow_loaded_weights_and_stay_out_of_state_dict():
    k, n = 16, 8
    port = _port_dense(_weights(17, k, n), np.zeros(n, np.float32), True)
    assert set(port.state_dict()) == {"weight", "bias"}
    w2 = _weights(18, k, n)
    port.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(w2.T)),
                          "bias": torch.zeros(n)})
    codes, scales = _port_codes(w2)
    torch.testing.assert_close(port.w_q, codes, rtol=0, atol=0)
    torch.testing.assert_close(port.w_scale, scales, rtol=0, atol=0)


def test_codes_out_is_for_the_kernels_only():
    w = _weights(19, 8, 4)
    tq, ts = _port_codes(w)
    with pytest.raises(ValueError, match="CUDA"):
        tint8.int8_dot(torch.zeros(2, 8), tq, ts, codes_out=torch.zeros(2, 8, dtype=torch.int8))



class _RecordingLibrary:
    """Stands in for the kernel library: records launches."""

    def __init__(self):
        self.calls = []

    def launch(self, name, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
def test_kernel_entry_reads_x_as_it_is(static, dtype, code):
    """What int8_dot hands the C entry on a card: one launch with the
    entry's argument count, x's own storage (a bf16 x is not converted)
    with its type code, K = 1,536 passed through, the output at (M, N)."""
    from velocity_asr_tpu_torch.ops import cuda_lib

    k, n = 1536, 70
    x = torch.from_numpy(_x(20, 2, 5, k)).to(dtype)
    tq, ts = _port_codes(_weights(21, k, n))
    xs = torch.tensor([0.01]) if static else None
    lib = _RecordingLibrary()
    out = tint8._launch_int8(lib, x, tq, ts, xs)
    assert out.shape == (2, 5, n) and out.dtype == torch.float32
    assert len(lib.calls) == 1
    name, args = lib.calls[0]
    assert name == ("int8_dense_static_f32" if static else "int8_dense_dynamic_f32")
    assert len(args) + 1 == len(cuda_lib.SIGNATURES[name])  # + the stream
    assert args[0] == x.data_ptr()
    n_ptr = 6 if static else 5
    assert args[n_ptr:] == (code, 10, k, n)
    if static:
        assert args[1] == xs.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_kernel_entry_refuses_other_types(dtype):
    tq, ts = _port_codes(_weights(22, 32, 8))
    lib = _RecordingLibrary()
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tint8._launch_int8(lib, torch.zeros(4, 32, dtype=dtype), tq, ts)
    assert lib.calls == []


def test_kernel_source_uses_tensor_cores_at_any_k():
    """The products are mma.sync s8 on the tensor cores (no __dp4a), the
    launcher opts into the shared memory it needs instead of refusing a
    K past the default 48 KB, and a call is one kernel."""
    import os

    with open(os.path.join(cuda_lib.CSRC_DIR, "int8_dense.cu")) as f:
        src = f.read()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "__dp4a" not in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert "kStaticSmem" not in src and "1012" not in src
    assert "atomicAdd" not in src and "atomicMax" not in src
    assert src.count("<<<") == 1
    with open(tint8.__file__) as f:
        assert "1,012" not in f.read()


def _f32(x):
    return np.asarray(x, np.float32)


def test_kernel_scale_rule_is_the_ieee_quotient():
    """csrc/int8_dense.cu's row_scale: q = a * fl(1/127), then of q and its
    two neighbours the one with the least residual |a - 127 c| (exact in
    float64, as the kernel's FMA is) is fl(a / 127), for every significand
    of one binade (the exponent only scales it) and at random magnitudes."""
    sig = (np.arange(1 << 23, dtype=np.uint32) | np.uint32(0x3F800000)).view(np.float32)
    rng = np.random.default_rng(5)
    rand = _f32(np.exp(rng.uniform(-40, 40, 200_000)))
    for a in (sig, rand, _f32(rand * 3.0)):
        q = _f32(a * np.float32(1.0 / 127.0))
        cands = np.stack([np.nextafter(q, -np.inf), q, np.nextafter(q, np.inf)])
        res = np.abs(a.astype(np.float64) - 127.0 * cands.astype(np.float64))
        picked = cands[np.argmin(res, axis=0), np.arange(a.size)]
        np.testing.assert_array_equal(picked, _f32(a / np.float32(127.0)))


@pytest.mark.parametrize("ulps", [-1, 0, 1])
def test_kernel_code_rule_is_the_ieee_quotient(ulps):
    """csrc/int8_dense.cu's codes4: rint(v * inv), inv within an ulp of 1/s
    (rcp.approx; both extremes taken here), gives rint(fl(v / s)) wherever
    |z - rint(z)| < 0.5 - 2e-6 |z|, and the rest (redone by the division)
    are rare: held at random scales and values, and at values within an
    ulp of s (j + 1/2) where the product and the quotient round apart."""
    rng = np.random.default_rng(6 + ulps)
    scales = _f32(np.exp(rng.uniform(-20, 8, 400)))
    scales[0] = np.float32(124.58155059814453) / np.float32(127.0)  # chip_smoke's tie scale
    checked = redone = 0
    for s in scales:
        inv = np.float32(1.0) / s
        for _ in range(abs(ulps)):
            inv = np.nextafter(inv, np.float32(np.inf) if ulps > 0 else np.float32(-np.inf))
        near = _f32(s * (np.arange(-127, 127) + 0.5))
        v = np.concatenate([_f32(rng.standard_normal(2000) * s * 60), near,
                            np.nextafter(near, -np.inf), np.nextafter(near, np.inf)]).astype(np.float32)
        z = _f32(v * inv)
        t = np.rint(z)
        flagged = np.abs(z - t).astype(np.float64) >= 0.5 - 2e-6 * np.abs(z).astype(np.float64)
        exact = np.clip(np.rint(_f32(v / s)), -127, 127)
        np.testing.assert_array_equal(np.clip(t, -127, 127)[~flagged], exact[~flagged])
        checked += v.size
        redone += int(flagged[:2000].sum())
    assert redone <= 1e-3 * 2000 * scales.size  # random values rarely take the division
    assert checked > 1_000_000
