"""The scan forward's CUDA entries as the CPU can check them: what the
source exports and how it is built, what the wrappers hand the library
(with a recording stand-in for it), and the reader of the forward's
per-phase timeline. The kernels run only on a card, where chip_smoke.py
holds them against their plain versions; here the timeline wrapper's
plain path is held against the JAX oracle (rtol/atol 1e-5, fp32 on both
sides, another summation order)."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu.ops import scan as jscan
from velocity_asr_tpu_torch.ops import cuda_lib
from velocity_asr_tpu_torch.ops import scan as tscan

ENTRIES = ("scan_fwd_f32", "scan_fwd_state_f32", "scan_fwd_bounds_f32",
           "scan_fwd_bounds_state_f32")


def _source():
    with open(os.path.join(cuda_lib.CSRC_DIR, "scan_fwd.cu")) as f:
        return f.read()


def _inputs(seed, batch=2, length=37, d_inner=16, state_dim=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, d_inner))
    dt = np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)) - 1.0))
    A = -np.arange(1, state_dim + 1)
    B = rng.standard_normal((batch, length, state_dim))
    C = rng.standard_normal((batch, length, state_dim))
    return [a.astype(np.float32) for a in (x, dt, A, B, C)]


def test_timeline_entry_and_plan_query_are_bound_and_exported():
    """The timeline entry, its buffer size and the plan query are extern
    "C" in the source, with the argument lists the loader binds."""
    src = _source()
    assert re.search(r'extern "C" cudaError_t scan_fwd_timeline_f32\(', src)
    assert re.search(r'extern "C" long long scan_fwd_timeline_clocks\(int batch, int L, int D, '
                     r'int N\)', src)
    assert re.search(r'extern "C" cudaError_t scan_fwd_occupancy\(int batch, int D, int N, '
                     r'int with_state,\s+int save_bounds, int\* out\)', src)
    sig = cuda_lib.SIGNATURES["scan_fwd_timeline_f32"]
    assert sig[:8] == [cuda_lib._P] * 8 and sig[8] is cuda_lib._LL and sig[-1] is cuda_lib._P
    assert len(sig) == 15  # 8 pointers, n_clocks, save_bounds, 4 sizes, the stream
    assert len(cuda_lib.OCCUPANCY_KEYS["scan_fwd_occupancy"]) == 11  # out[0..10] in the source
    assert "out[10] = plan.passes;" in src


def test_entries_keep_their_signatures():
    """The four forward entries take what they took before the redesign:
    no scratch, so the wrappers and the other trees' callers are unchanged."""
    p, i = cuda_lib._P, cuda_lib._I
    assert cuda_lib.SIGNATURES["scan_fwd_f32"] == [p] * 6 + [i] * 4 + [p]
    assert cuda_lib.SIGNATURES["scan_fwd_state_f32"] == [p] * 8 + [i] * 4 + [p]
    assert cuda_lib.SIGNATURES["scan_fwd_bounds_f32"] == [p] * 7 + [i] * 4 + [p]
    assert cuda_lib.SIGNATURES["scan_fwd_bounds_state_f32"] == [p] * 9 + [i] * 4 + [p]


def test_paths_run_without_the_timeline_and_the_plan_ignores_length():
    """Every entry a path calls instantiates the kernel with kTimeline off;
    only the timeline entry turns it on. The launcher's plan is a function
    of (batch, D, N), never of L, so a chunk split in two launches runs
    the same plan."""
    src = _source()
    body = {name: src.split(f'extern "C" cudaError_t {name}(')[1].split("\n}\n")[0]
            for name in ENTRIES + ("scan_fwd_timeline_f32",)}
    for name, (state, bounds) in zip(ENTRIES, ((0, 0), (1, 0), (0, 1), (1, 1))):
        flags = f"dispatch<{'true' if state else 'false'}, {'true' if bounds else 'false'}>("
        assert flags in body[name], name
    assert "dispatch<false, true, true>(" in body["scan_fwd_timeline_f32"]
    assert "dispatch<false, false, true>(" in body["scan_fwd_timeline_f32"]
    assert "Plan plan_for(int batch, int D, int N)" in src
    assert src.count("plan_for(") == 4  # the definition, dispatch, the clock count, the query


def test_source_keeps_the_earlier_rounding_and_no_fast_math():
    """The state update is the one FMA fma(decay, h, B * u) with the IEEE
    expf, tiles are double-buffered by cp.async, and nothing approximates
    the exponential."""
    src = _source()
    assert "__fmaf_rn(decay, h, __fmul_rn(b, u))" in src
    assert "expf(__fmul_rn(delta, a))" in src
    assert "cp.async.cg.shared.global" in src and "slot ^ 1" in src
    for fast in ("__expf", "ex2.approx", "exp2f", "--use_fast_math"):
        assert fast not in src
    assert "--use_fast_math" not in cuda_lib.NVCC_FLAGS + cuda_lib.LINK_FLAGS


class _RecordingLibrary:
    """Stands in for the kernel library: reports a clock-buffer size known
    to the test and records launches."""

    CLOCKS = 321

    def __init__(self):
        self.calls, self.asked = [], []
        self.lib = self

    def scan_fwd_timeline_clocks(self, *sizes):
        self.asked.append(sizes)
        return self.CLOCKS

    def launch(self, name, *args):
        self.calls.append((name, args))


@pytest.mark.parametrize("save_bounds", [False, True])
def test_timeline_wrapper_passes_its_buffers(save_bounds):
    """One launch of the timeline entry with y, the bounds (or no pointer),
    an int64 clock buffer of the size the library asked for, that size,
    the flag and the sizes, in the bound order."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(1, batch=2, length=37, d_inner=16,
                                                              state_dim=8))
    lib = _RecordingLibrary()
    y, bounds, clocks = tscan._launch_timeline(lib, x, dt, A, B, C, save_bounds)
    assert lib.asked == [(2, 37, 16, 8)]
    assert len(lib.calls) == 1
    name, args = lib.calls[0]
    assert name == "scan_fwd_timeline_f32"
    assert len(args) + 1 == len(cuda_lib.SIGNATURES[name])  # + the stream
    assert clocks.dtype == torch.int64 and tuple(clocks.shape) == (lib.CLOCKS,)
    assert args[:6] == tuple(t.data_ptr() for t in (x, dt, A, B, C, y))
    assert args[6] == (bounds.data_ptr() if save_bounds else None)
    assert args[7:] == (clocks.data_ptr(), lib.CLOCKS, int(save_bounds), 2, 37, 16, 8)
    assert tuple(y.shape) == (2, 37, 16)
    if save_bounds:
        assert tuple(bounds.shape) == (2, 3, 16, 8) and bounds.dtype == torch.float32
    else:
        assert bounds is None


@pytest.mark.parametrize("save_bounds", [False, True])
def test_timeline_wrapper_on_cpu_is_the_plain_scan(save_bounds):
    """On CPU tensors the timeline wrapper runs the plain version (no
    clocks); its y is the JAX oracle's (without the D * x skip)."""
    arrays = _inputs(2)
    t = [torch.from_numpy(a) for a in arrays]
    y, bounds, clocks = tscan.scan_fwd_timeline(*t, save_bounds=save_bounds)
    assert clocks is None
    zero_d = np.zeros(arrays[0].shape[-1], np.float32)
    ref = jscan.selective_scan_sequential(*map(jnp.asarray, arrays), jnp.asarray(zero_d))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if save_bounds:
        torch.testing.assert_close(bounds, tscan.scan_fwd_bounds_plain(*t)[1], rtol=0, atol=0)
    else:
        assert bounds is None


def _clock_buffer(n_tiles, passes=1, start=1000, per_phase=(5, 7, 3, 2, 40, 6), tail=4):
    """A timeline buffer as the kernel lays it out: 3 blocks on 2 SMs,
    block (0, 0)'s stamps with the given cycles per tile phase, then the
    global timer."""
    records = [[0, 100, 900], [1, 120, 1000], [0, 950, 1500]]  # (SM, start ns, end ns)
    stamps = [start]
    for _ in range(passes):
        for _ in range(n_tiles):
            for cycles in per_phase:
                stamps.append(stamps[-1] + cycles)
        stamps.append(stamps[-1] + tail)
    total = stamps[-1] - stamps[0]
    return [len(records)] + sum(records, []) + stamps + [5000, 5000 + total // 2]


def test_timeline_shares_read_the_stamp_layout():
    """Phase cycles are summed over tiles and passes, shares are of the
    first-to-last span, the clock is cycles over the global timer's
    nanoseconds, and the block records give the kernel's span, the blocks'
    own times, the most blocks an SM ran and the blocks that started late."""
    length = 37  # 3 tiles of 16
    shares = tscan.timeline_shares(torch.tensor(_clock_buffer(3, passes=2)), length)
    per_tile = dict(zip(tscan.TIMELINE_TILE_PHASES, (5, 7, 3, 2, 40, 6)))
    total = 2 * (3 * 63 + 4)
    assert shares["total"] == (total, 1.0)
    for phase, cycles in per_tile.items():
        assert shares[phase][0] == 2 * 3 * cycles
        assert shares[phase][1] == pytest.approx(2 * 3 * cycles / total)
    assert shares["tail"][0] == 8
    assert sum(shares[p][0] for p in tscan.TIMELINE_PHASES) == total
    assert shares["clock_ghz"] == pytest.approx(total / (total // 2))
    blocks = shares["blocks"]
    assert blocks["count"] == 3 and blocks["sms"] == 2 and blocks["per_sm_max"] == 2
    assert blocks["span_us"] == pytest.approx(1.4)
    assert blocks["block_us"] == (pytest.approx(0.8), pytest.approx(0.55), pytest.approx(0.88))
    assert blocks["late_blocks"] == 1
    with pytest.raises(ValueError, match="tiles a pass"):
        tscan.timeline_shares(torch.tensor(_clock_buffer(3)), 64)  # 4 tiles expected


def test_timeline_needs_a_card_or_a_cpu_tensor():
    """The timeline wrapper refuses an empty scan only on the card's path;
    on the CPU an empty scan is the plain version's (zeros)."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in _inputs(3, length=1))
    y, _, clocks = tscan.scan_fwd_timeline(x[:, :0], dt[:, :0], A, B[:, :0], C[:, :0])
    assert y.shape == (2, 0, 16) and clocks is None
