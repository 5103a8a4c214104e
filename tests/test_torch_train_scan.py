"""Parity of the port's training scan (ops/scan.py) with the JAX package's.

The plain bounds-saving forward and the plain backward (the CUDA kernels'
plain versions) are held against the Pallas kernels in interpret mode
(``_pallas_scan_fwd(save_bounds=True)``, ``_pallas_scan_bwd``) on the
same numpy inputs, with L not a multiple of 16; the JAX bounds layout
(batch, chunks, N, d_inner) is swapped to the port's (batch, chunks,
d_inner, N) on the JAX side. ``SelectiveScanFn`` is held against
``jax.grad`` of the lax.scan oracle. Tolerance rtol/atol 1e-5: fp32 on
both sides, different summation orders (dA sums over every (b, t, d)).
The CUDA kernels run only on a card; chip_smoke.py holds them against
these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu.ops import scan as jscan
from velocity_asr_tpu.ops.scan_pallas import TRAIN_CHUNK, _pallas_scan_bwd, _pallas_scan_fwd
from velocity_asr_tpu_torch.ops import scan as tscan

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, batch=2, length=37, d_inner=16, state_dim=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, d_inner))
    dt = np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)) - 1.0))
    A = -np.exp(np.log(np.arange(1, state_dim + 1)) + 0.1 * rng.standard_normal(state_dim))
    B = rng.standard_normal((batch, length, state_dim))
    C = rng.standard_normal((batch, length, state_dim))
    D = rng.standard_normal(d_inner)
    g = rng.standard_normal((batch, length, d_inner))
    return [a.astype(dtype) for a in (x, dt, A, B, C, D, g)]


def _torch(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def test_train_chunk_is_the_jax_one():
    assert tscan.TRAIN_CHUNK == TRAIN_CHUNK == 16


@pytest.mark.parametrize("length,state_dim", [(37, 8), (50, 16)])
def test_plain_bounds_forward_matches_pallas(length, state_dim):
    x, dt, A, B, C, _, _ = _inputs(length, length=length, state_dim=state_dim)
    y_ref, bounds_ref = _pallas_scan_fwd(*map(jnp.asarray, (x, dt, A, B, C)), TRAIN_CHUNK,
                                         save_bounds=True)
    y, bounds = tscan.scan_fwd_bounds_plain(*_torch(x, dt, A, B, C))
    assert bounds.shape == (2, -(-length // 16), 16, state_dim)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(bounds.numpy(), np.swapaxes(np.asarray(bounds_ref), 2, 3), **TOL)
    # chunk 0 enters from zeros; y is the no-bounds scan's
    assert not bounds[:, 0].any()
    torch.testing.assert_close(y, tscan.scan_fwd_plain(*_torch(x, dt, A, B, C)), rtol=0, atol=0)


@pytest.mark.parametrize("length,state_dim", [(37, 8), (50, 16)])
def test_plain_backward_matches_pallas(length, state_dim):
    x, dt, A, B, C, _, g = _inputs(100 + length, length=length, state_dim=state_dim)
    jx = list(map(jnp.asarray, (x, dt, A, B, C)))
    _, bounds_ref = _pallas_scan_fwd(*jx, TRAIN_CHUNK, save_bounds=True)
    refs = _pallas_scan_bwd(*jx, bounds_ref, jnp.asarray(g), TRAIN_CHUNK)
    t = _torch(x, dt, A, B, C)
    _, bounds = tscan.scan_fwd_bounds_plain(*t)
    outs = tscan.scan_bwd_plain(*t, bounds, torch.tensor(g))
    for name, out, ref in zip(("dx", "ddt", "dA", "dB", "dC"), outs, refs):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL, err_msg=name)


def test_selective_scan_fn_matches_jax_grad():
    """The Function's gradients (D*x skip outside, in autograd) against
    jax.grad of the lax.scan oracle, for sum(w * y)."""
    x, dt, A, B, C, D, w = _inputs(7, length=41, state_dim=8)

    def loss(*args):
        return jnp.sum(jnp.asarray(w) * jscan.selective_scan_sequential(*args))

    refs = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, (x, dt, A, B, C, D)))
    t = _torch(x, dt, A, B, C, D, grad=True)
    y = tscan.selective_scan(*t, mode="pallas")
    assert y.grad_fn is not None
    (torch.tensor(w) * y).sum().backward()
    for name, arg, ref in zip(("x", "dt", "A", "B", "C", "D"), t, refs):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def test_selective_scan_takes_the_function_only_under_grad(monkeypatch):
    """Under grad the scan goes through SelectiveScanFn (the bounds forward
    and the backward); under no_grad, or with no input needing grad, the
    plain no-state forward, as inference always ran."""
    x, dt, A, B, C, D, _ = _inputs(3)
    calls = []
    for name in ("scan_fwd", "scan_fwd_bounds", "scan_bwd"):
        fn = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    t = _torch(x, dt, A, B, C, D, grad=True)
    with torch.no_grad():
        tscan.selective_scan(*t, mode="pallas")
    tscan.selective_scan(*_torch(x, dt, A, B, C, D), mode="pallas")
    assert calls == ["scan_fwd", "scan_fwd"]
    tscan.selective_scan(*t, mode="parallel").sum().backward()
    assert calls[2:] == ["scan_fwd_bounds", "scan_bwd"]


def test_gradcheck_plain_pair_fp64():
    """The plain forward and backward in fp64 pass autograd's numerical
    gradient check (L = 21: a full chunk and a 5-step tail)."""
    x, dt, A, B, C, _, _ = _inputs(11, batch=1, length=21, d_inner=3, state_dim=3,
                                   dtype=np.float64)
    args = _torch(x, dt, A, B, C, grad=True)
    assert torch.autograd.gradcheck(tscan.SelectiveScanFn.apply, args, eps=1e-6, atol=1e-6)


def test_carried_state_scan_under_grad_raises():
    """The carried-state scan under grad: its forward runs as inference
    does, and a backward through y, through h_final alone, or to an h0
    that alone needs grad no longer raises: it gives autograd's gradients
    of the plain loop (the oracle, differentiated step by step). Under
    no_grad the output has no grad_fn. (The name dates from when the
    backward raised.)"""
    x, dt, A, B, C, D, _ = _inputs(5)
    h0 = torch.tensor(np.random.default_rng(6).standard_normal((2, 16, 8)).astype(np.float32))

    def oracle_grads(loss_of, with_h0=False):
        t = _torch(x, dt, A, B, C, D, grad=True)
        h = h0.clone().requires_grad_(with_h0)
        loss_of(*tscan.selective_scan_sequential(*t, h0=h, return_state=True)).backward()
        return [a.grad for a in t] + ([h.grad] if with_h0 else [])

    t = _torch(x, dt, A, B, C, D, grad=True)
    y = tscan.selective_scan(*t, mode="pallas", h0=h0)
    ref = tscan.selective_scan_sequential(*[a.detach() for a in t], h0=h0)
    torch.testing.assert_close(y.detach(), ref, rtol=1e-6, atol=1e-6)
    y.sum().backward()
    for got, want in zip([a.grad for a in t], oracle_grads(lambda y_, h_: y_.sum())):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    t = _torch(x, dt, A, B, C, D, grad=True)
    _, h = tscan.selective_scan(*t, mode="pallas", return_state=True)
    h.sum().backward()
    assert all(a.grad is not None for a in t[:5]) and t[5].grad is None  # D acts on y only
    # a state that needs grad alone
    h_in = h0.clone().requires_grad_()
    y = tscan.selective_scan(*_torch(x, dt, A, B, C, D), mode="pallas", h0=h_in)
    y.sum().backward()
    torch.testing.assert_close(h_in.grad, oracle_grads(lambda y_, h_: y_.sum(), True)[-1],
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # inference keeps the plain carried-state scan
        y, h = tscan.selective_scan(*t, mode="pallas", h0=h0, return_state=True)
    assert y.grad_fn is None and h.shape == (2, 16, 8)


def _csrc(name):
    import os

    from velocity_asr_tpu_torch.ops import cuda_lib

    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        return f.read()


def test_backward_is_one_deterministic_launch_in_the_source():
    """The backward's C entries start one clustered kernel whose
    cross-block sums use integer arrival counters, not float atomics or a
    second reduction kernel."""
    src = _csrc("scan_bwd.cu")
    assert "__cluster_dims__(kCluster, 1, 1)" in src
    assert "scan_bwd_reduce_kernel" not in src and "atomicAdd(&count" in src
    # the counters are the call's own: zeroed on its stream before the kernel
    assert "cudaMemsetAsync(count, 0" in src and "count[b] = 0" not in src
    assert "atomicAdd(d" not in src and "atomicAdd(part" not in src
    assert src.count("<<<") == 1


class _RecordingLibrary:
    """Stands in for the kernel library: asks for a workspace of a size
    known to the test and records launches."""

    WORK = 1234

    def __init__(self):
        self.calls = []
        self.asked = []
        self.lib = self

    def scan_bwd_workspace_floats(self, *sizes):
        self.asked.append(sizes)
        return self.WORK

    def launch(self, name, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("with_state", [False, True])
def test_backward_wrapper_is_one_launch_with_its_workspace(with_state):
    """What scan_bwd / scan_bwd_state hand the C entry on a card: one
    launch, the workspace the library asked for at these sizes (its
    pointer and its size, which the C side checks; the arrival counters
    live at its end), and every output allocated at its shape."""
    x, dt, A, B, C, _, g = _torch(*_inputs(3, batch=2, length=37, d_inner=16, state_dim=8))
    _, bounds = tscan.scan_fwd_bounds_plain(x, dt, A, B, C)
    lib = _RecordingLibrary()
    gh = torch.zeros(2, 16, 8) if with_state else None
    outs = tscan._launch_bwd(lib, x, dt, A, B, C, bounds, g, gh)
    assert len(lib.calls) == 1
    name, args = lib.calls[0]
    assert name == ("scan_bwd_state_f32" if with_state else "scan_bwd_f32")
    from velocity_asr_tpu_torch.ops import cuda_lib

    assert len(args) + 1 == len(cuda_lib.SIGNATURES[name])  # + the stream
    n_ptr = 15 if with_state else 13
    assert lib.asked == [(2, 37, 16, 8)]
    assert args[n_ptr:] == (lib.WORK, 2, 37, 16, 8)
    assert [tuple(o.shape) for o in outs] == (
        [(2, 37, 16), (2, 37, 16), (8,), (2, 37, 8), (2, 37, 8)] + ([(2, 16, 8)] if with_state
                                                                   else []))


def test_kernel_library_counts_one_per_launch(monkeypatch):
    """KernelLibrary.launch adds one to the entry's count when its C
    launcher returns 0, and raises without counting when it does not."""
    from velocity_asr_tpu_torch.ops import cuda_lib

    class _Lib:
        @staticmethod
        def scan_bwd_f32(*args):
            return 0 if args[0] == 1 else 700

        @staticmethod
        def kernel_error_string(rc):
            return b"an illegal memory access was encountered"

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    kl = object.__new__(cuda_lib.KernelLibrary)
    kl.lib = _Lib()
    before = cuda_lib.launch_counts["scan_bwd_f32"]
    kl.launch("scan_bwd_f32", 1)
    assert cuda_lib.launch_counts["scan_bwd_f32"] == before + 1
    with pytest.raises(RuntimeError, match="illegal memory access"):
        kl.launch("scan_bwd_f32", 2)
    assert cuda_lib.launch_counts["scan_bwd_f32"] == before + 1
    cuda_lib.launch_counts.subtract({"scan_bwd_f32": 1})
    if not cuda_lib.launch_counts["scan_bwd_f32"]:
        del cuda_lib.launch_counts["scan_bwd_f32"]
