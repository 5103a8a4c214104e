"""Parity of the port's selective scan (ops/scan.py) with the JAX package's.

The plain version of the CUDA kernel (a loop over t) is held against the
JAX oracle ``selective_scan_sequential`` (lax.scan) and against the
Pallas kernel in interpret mode, on the same numpy inputs. Tolerance
rtol 1e-5 / atol 1e-5: fp32 on both sides, different summation order in
the C . h reduction. The CUDA kernel itself runs only on a card and is
held against this plain version by chip_smoke.py.
"""

import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu.ops import scan as jscan
from velocity_asr_tpu_torch.ops import cuda_lib
from velocity_asr_tpu_torch.ops import scan as tscan

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, batch=2, length=37, d_inner=16, state_dim=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, d_inner)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)))).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, state_dim + 1, dtype=np.float32))
                + 0.1 * rng.standard_normal(state_dim)).astype(np.float32)
    B = rng.standard_normal((batch, length, state_dim)).astype(np.float32)
    C = rng.standard_normal((batch, length, state_dim)).astype(np.float32)
    D = rng.standard_normal(d_inner).astype(np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("length,state_dim", [(1, 8), (37, 8), (64, 16), (100, 32)])
def test_plain_scan_matches_jax_sequential(length, state_dim):
    args = _inputs(length + state_dim, length=length, state_dim=state_dim)
    ref = jscan.selective_scan_sequential(*map(jnp.asarray, args))
    t = [torch.from_numpy(a) for a in args]
    np.testing.assert_allclose(tscan.selective_scan_sequential(*t).numpy(), ref, **TOL)
    y = tscan.scan_fwd_plain(*t[:5]) + t[0] * t[5]
    np.testing.assert_allclose(y.numpy(), ref, **TOL)


@pytest.mark.parametrize("length", [40, 70])
def test_kernel_path_matches_jax_pallas_interpret(length):
    args = _inputs(7, batch=1, length=length, d_inner=16, state_dim=8)
    ref = jscan.selective_scan(*map(jnp.asarray, args), mode="pallas")
    out = tscan.selective_scan(*[torch.from_numpy(a) for a in args], mode="pallas")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["pallas", "parallel"])
def test_modes_agree_on_cpu(mode):
    t = [torch.from_numpy(a) for a in _inputs(3)]
    torch.testing.assert_close(tscan.selective_scan(*t, mode=mode),
                               tscan.selective_scan(*t, mode="sequential"), rtol=0, atol=0)


def test_unknown_mode_raises():
    """An unknown mode raises; "sp" (ported) raises outside its context."""
    t = [torch.from_numpy(a) for a in _inputs(4)]
    with pytest.raises(ValueError, match="Unknown scan mode"):
        tscan.selective_scan(*t, mode="bogus")
    with pytest.raises(ValueError, match="sequence_parallel"):
        tscan.selective_scan(*t, mode="sp")


def test_wrapper_takes_plain_version_for_cpu_tensors():
    t = [torch.from_numpy(a) for a in _inputs(5)]
    before = dict(cuda_lib.launch_counts)
    torch.testing.assert_close(tscan.scan_fwd(*t[:5]), tscan.scan_fwd_plain(*t[:5]),
                               rtol=0, atol=0)
    assert dict(cuda_lib.launch_counts) == before  # no kernel launch counted


def test_check_tensor_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.check_tensor(torch.zeros(2, 3), "x", (2, 3))


def test_sources_export_every_launcher():
    """Every launcher the loader binds is an extern "C" function returning
    cudaError_t in csrc/, and every .cu file says which TPU kernel it
    replaces (or is the error-string helper)."""
    sources = {}
    for path in glob.glob(os.path.join(cuda_lib.CSRC_DIR, "*.cu")):
        with open(path) as f:
            sources[os.path.basename(path)] = f.read()
    assert {"scan_fwd.cu", "log_mel.cu", "int8_dense.cu"} <= set(sources)
    text = "\n".join(sources.values())
    for name in cuda_lib.SIGNATURES:
        assert re.search(rf'extern "C" cudaError_t {name}\(', text), name
    assert 'extern "C" const char* kernel_error_string' in text
    for fname in ("scan_fwd.cu", "log_mel.cu", "int8_dense.cu"):
        assert "Replaces: velocity_asr_tpu/ops/" in sources[fname]
        assert "torch/" not in sources[fname]  # no PyTorch headers
    assert "--use_fast_math" not in cuda_lib.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


def test_kernel_state_dims_cover_the_main_path():
    """The kernel takes any state size: the wrapper has no allowlist, the
    launcher no case that refuses a size, and the plain version the kernel
    is held against matches the JAX oracle at each width chip_smoke.py
    launches and at one past 256 (which the kernel walks in passes)."""
    assert not hasattr(tscan, "KERNEL_STATE_DIMS")
    with open(os.path.join(cuda_lib.CSRC_DIR, "scan_fwd.cu")) as f:
        src = f.read()
    assert "default: return cudaErrorInvalidValue" not in src
    for state_dim in (1, 4, 8, 24, 64, 128, 300):
        args = _inputs(state_dim, batch=2, length=9, d_inner=8, state_dim=state_dim)
        ref = jscan.selective_scan_sequential(*map(jnp.asarray, args))
        t = [torch.from_numpy(a) for a in args]
        out = tscan.scan_fwd(*t[:5]) + t[0] * t[5]
        np.testing.assert_allclose(out.numpy(), ref, **TOL, err_msg=f"N={state_dim}")


# ------------------------------------------------------- carried state


def _state(seed, batch, d_inner, state_dim):
    return np.random.default_rng(seed).standard_normal(
        (batch, d_inner, state_dim)).astype(np.float32)


@pytest.mark.parametrize("state_dim", [4, 8, 300])
def test_plain_scan_with_state_matches_jax(state_dim):
    """scan_fwd_plain seeded by h0 returns (y, h_final) in the oracle's
    (batch, d_inner, N) layout: against lax.scan and the Pallas kernel
    (interpret mode), which returns the state swapped back from its
    (batch, N, d_inner) layout."""
    from velocity_asr_tpu.ops.scan_pallas import selective_scan_pallas

    args = _inputs(state_dim + 1, batch=2, length=21, d_inner=16, state_dim=state_dim)
    h0 = _state(state_dim, 2, 16, state_dim)
    jargs = [jnp.asarray(a) for a in args]
    refs = [jscan.selective_scan_sequential(*jargs, h0=jnp.asarray(h0), return_state=True),
            selective_scan_pallas(*jargs, h0=jnp.asarray(h0), return_state=True)]
    t = [torch.from_numpy(a) for a in args]
    y, h = tscan.scan_fwd_plain(*t[:5], torch.from_numpy(h0), return_state=True)
    y = y + t[0] * t[5]
    assert h.shape == (2, 16, state_dim) and h.dtype == torch.float32
    for ref_y, ref_h in refs:
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    for mode in ("pallas", "sequential"):
        ys, hs = tscan.selective_scan(*t, mode=mode, h0=torch.from_numpy(h0),
                                      return_state=True)
        np.testing.assert_allclose(ys.numpy(), np.asarray(refs[0][0]), **TOL)
        np.testing.assert_allclose(hs.numpy(), np.asarray(refs[0][1]), **TOL)


def test_scan_seam_two_chunks_equal_one():
    """Scanning [0, L) as [0, L/2) and [L/2, L) with the carried state gives
    the one-pass result within 1e-6 relative: the property streaming rests on."""
    args = [torch.from_numpy(a) for a in _inputs(9, batch=3, length=40, state_dim=8)]
    h0 = torch.from_numpy(_state(10, 3, 16, 8))
    y, h = tscan.scan_fwd_state(*args[:5], h0)
    first = [a[:, :20].contiguous() for a in args[:2]] + [args[2]] + [
        a[:, :20].contiguous() for a in args[3:5]]
    second = [a[:, 20:].contiguous() for a in args[:2]] + [args[2]] + [
        a[:, 20:].contiguous() for a in args[3:5]]
    y1, h1 = tscan.scan_fwd_state(*first, h0)
    y2, h2 = tscan.scan_fwd_state(*second, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-6, atol=0)
    torch.testing.assert_close(h2, h, rtol=1e-6, atol=0)


def test_state_wrapper_on_cpu_runs_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(11, state_dim=8)]
    h0 = torch.from_numpy(_state(12, 2, 16, 8))
    before = dict(cuda_lib.launch_counts)
    y, h = tscan.scan_fwd_state(*args[:5], h0)
    ref_y, ref_h = tscan.scan_fwd_plain(*args[:5], h0, return_state=True)
    torch.testing.assert_close(y, ref_y, rtol=0, atol=0)
    torch.testing.assert_close(h, ref_h, rtol=0, atol=0)
    # zero seed: the offline scan's y
    y0, _ = tscan.scan_fwd_state(*args[:5], torch.zeros_like(h0))
    torch.testing.assert_close(y0, tscan.scan_fwd(*args[:5]), rtol=0, atol=0)
    # an empty chunk hands back a copy of h0
    empty = [a[:, :0] for a in args[:2]] + [args[2]] + [a[:, :0] for a in args[3:5]]
    y_e, h_e = tscan.scan_fwd_state(*empty, h0)
    assert y_e.shape == (2, 0, 16)
    torch.testing.assert_close(h_e, h0, rtol=0, atol=0)
    assert h_e.data_ptr() != h0.data_ptr()
    assert dict(cuda_lib.launch_counts) == before  # no kernel launch counted
    # no seed and no state asked for: the stateless scan, as before
    out = tscan.selective_scan(*args, mode="pallas")
    torch.testing.assert_close(out, tscan.scan_fwd(*args[:5]) + args[0] * args[5],
                               rtol=0, atol=0)
