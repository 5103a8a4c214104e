"""The port's streaming-aware training path against the JAX package's.

The same numpy inputs and weights go through both packages:

- the carried-state training scan: the plain bounds forward seeded by h0
  and the plain backward seeded by gh (the CUDA kernels' plain versions)
  against the Pallas launchers in interpret mode,
  ``_pallas_scan_fwd_state(save_bounds=True)`` and
  ``_pallas_scan_bwd(gh=...)``, with the JAX (batch, N, d_inner) state
  layouts swapped to the port's (batch, d_inner, N), L not a multiple of
  16, N in {4, 8}: rtol/atol 1e-5 (fp32, other summation orders);
  ``CarriedStateScanFn`` against ``jax.grad`` of the lax.scan oracle with
  h0 and return_state, the loss on y and h_final: atol 1e-4 (as the
  no-state Function's test); an fp64 ``gradcheck``; two carried chunks
  against one chunk: gradients within 1e-6 of each one's max|grad|;
- ``causal_normalize_mel`` and ``masked_normalize_mel`` against the JAX
  functions, n_valid < t and t not a multiple of the chunk: atol 1e-5;
- ``streaming_forward`` against the JAX one on a small fp32 model
  (d_model 32, 3 chunks; JAX runs its sequential oracle scan, the port the
  kernel path's plain versions): logits atol 1e-4, and the input and
  parameter gradients of a loss on the logits within 1e-4 of each
  gradient's max|grad| (a gradient that is 0 in exact arithmetic, the key
  projection's bias, within 1e-4 of the largest);
- synth device-mel items, manifest device-mel items and the audio
  collation: bit-exact;
- one update of the streaming-aware objective on device-mel batches
  (dropout 0, SpecAugment off) against the JAX ``Trainer``: loss within
  1e-5 relative; weights as in ``test_torch_training``'s update test
  (every weight within 2 lr, those with a large enough gradient within
  1e-6), except that "large enough" is |grad| > 3e-5, not 1e-5: the mels
  differ here (XLA's rfft in JAX, DFT matmuls in the port, within 1e-4
  on log-mel), the gradient's global norm of 40 is clipped to 1, and
  Adam's first step lr * g / (|g| + 1e-8) at a clipped |g| near 2.5e-7
  follows g's fourth digit;
- SpecAugment's masks are the same in both views, ``eval_step`` adds the
  streaming term (a host-mel batch keeps the offline loss), waveform
  augmentation on device-mel batches still raises through the CLI, the
  recipe's YAML maps as the JAX package maps it, and the CLI runs 2
  steps on the CPU. (Streaming without device-mel batches is a
  ``ValueError``: a case of ``test_torch_training``'s
  ``test_unported_options_raise``.)
"""

import copy
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velocity_asr_tpu import audio as jaudio
from velocity_asr_tpu import data as jdata
from velocity_asr_tpu import streaming as jstream
from velocity_asr_tpu import synth as jsynth
from velocity_asr_tpu import training as jtraining
from velocity_asr_tpu.models import config as jconfig
from velocity_asr_tpu.models import model as jmodel
from velocity_asr_tpu.ops import scan as jscan
from velocity_asr_tpu.ops.scan_pallas import TRAIN_CHUNK, _pallas_scan_bwd, _pallas_scan_fwd_state
from velocity_asr_tpu.utils import config as jyaml
from velocity_asr_tpu_torch import audio as taudio
from velocity_asr_tpu_torch import augment as taugment
from velocity_asr_tpu_torch import config as tyaml
from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import streaming as tstream
from velocity_asr_tpu_torch import synth as tsynth
from velocity_asr_tpu_torch import train as ttrain
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.checkpoint import _flatten, params_from_numpy, params_to_numpy
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.ops import scan as tscan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_YAML = os.path.join(ROOT, "configs", "train_synth_stream.yaml")
TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 64  # streaming chunk (mel frames) of the small models
SMALL = dict(d_model=32, ssm_layers=2, ssm_state_dim=8, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=4, attention_dim=16, vocab_size=30,
             dropout=0.0, dtype="float32", stream_summary_tokens=16, stream_memory_chunks=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scan_inputs(seed, batch=2, length=37, d_inner=16, state_dim=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, d_inner))
    dt = np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)) - 1.0))
    A = -np.exp(np.log(np.arange(1, state_dim + 1)) + 0.1 * rng.standard_normal(state_dim))
    B = rng.standard_normal((batch, length, state_dim))
    C = rng.standard_normal((batch, length, state_dim))
    D = rng.standard_normal(d_inner)
    h0 = rng.standard_normal((batch, d_inner, state_dim))
    g = rng.standard_normal((batch, length, d_inner))
    gh = rng.standard_normal((batch, d_inner, state_dim))
    return [a.astype(dtype) for a in (x, dt, A, B, C, D, h0, g, gh)]


def _torch(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# ----- the carried-state training scan -------------------------------------------


@pytest.mark.parametrize("length,state_dim", [(37, 4), (50, 8)])
def test_plain_bounds_state_forward_matches_pallas(length, state_dim):
    x, dt, A, B, C, _, h0, _, _ = _scan_inputs(length, length=length, state_dim=state_dim)
    y_ref, bounds_ref, h_ref = _pallas_scan_fwd_state(
        *map(jnp.asarray, (x, dt, A, B, C)), TRAIN_CHUNK, jnp.asarray(np.swapaxes(h0, 1, 2)),
        save_bounds=True)
    y, bounds, h_final = tscan.scan_fwd_bounds_plain(*_torch(x, dt, A, B, C, h0),
                                                     return_state=True)
    assert bounds.shape == (2, -(-length // 16), 16, state_dim)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(bounds.numpy(), np.swapaxes(np.asarray(bounds_ref), 2, 3), **TOL)
    np.testing.assert_allclose(h_final.numpy(), np.swapaxes(np.asarray(h_ref), 1, 2), **TOL)
    # chunk 0 enters from h0; y and h_final are the carried-state scan's
    assert torch.equal(bounds[:, 0], torch.tensor(h0))
    y_state, h_state = tscan.scan_fwd_plain(*_torch(x, dt, A, B, C, h0), return_state=True)
    assert torch.equal(y, y_state) and torch.equal(h_final, h_state)


@pytest.mark.parametrize("length,state_dim", [(37, 4), (50, 8)])
def test_plain_state_backward_matches_pallas(length, state_dim):
    x, dt, A, B, C, _, h0, g, gh = _scan_inputs(200 + length, length=length,
                                                state_dim=state_dim)
    jx = list(map(jnp.asarray, (x, dt, A, B, C)))
    _, bounds_ref, _ = _pallas_scan_fwd_state(*jx, TRAIN_CHUNK,
                                              jnp.asarray(np.swapaxes(h0, 1, 2)),
                                              save_bounds=True)
    refs = _pallas_scan_bwd(*jx, bounds_ref, jnp.asarray(g), TRAIN_CHUNK,
                            gh=jnp.asarray(np.swapaxes(gh, 1, 2)))
    t = _torch(x, dt, A, B, C)
    _, bounds, _ = tscan.scan_fwd_bounds_plain(*t, torch.tensor(h0), return_state=True)
    outs = tscan.scan_bwd_plain(*t, bounds, torch.tensor(g), torch.tensor(gh))
    assert len(outs) == 6
    for name, out, ref in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), outs, refs):
        ref = np.asarray(ref)
        if name == "dh0":
            ref = np.swapaxes(ref, 1, 2)
        np.testing.assert_allclose(out.numpy(), ref, **TOL, err_msg=name)
    # without gh the backward is the no-state one, bit for bit
    no_state = tscan.scan_bwd_plain(*t, bounds, torch.tensor(g))
    zero = tscan.scan_bwd_plain(*t, bounds, torch.tensor(g), torch.zeros(2, 16, state_dim))
    assert len(no_state) == 5 and all(torch.equal(a, b) for a, b in zip(no_state, zero))


def test_carried_state_fn_matches_jax_grad():
    """Gradients of sum(wy * y) + sum(wh * h_final) with respect to x, dt,
    A, B, C, D and h0 (the D*x skip outside the Function, in autograd)
    against jax.grad of the lax.scan oracle."""
    x, dt, A, B, C, D, h0, wy, wh = _scan_inputs(9, length=41, state_dim=8)

    def loss(*args):
        y, h = jscan.selective_scan_sequential(*args[:6], h0=args[6], return_state=True)
        return jnp.sum(jnp.asarray(wy) * y) + jnp.sum(jnp.asarray(wh) * h)

    refs = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, (x, dt, A, B, C, D, h0)))
    t = _torch(x, dt, A, B, C, D, h0, grad=True)
    y, h = tscan.selective_scan(*t[:6], mode="pallas", h0=t[6], return_state=True)
    assert y.grad_fn is not None and h.grad_fn is not None
    ((torch.tensor(wy) * y).sum() + (torch.tensor(wh) * h).sum()).backward()
    for name, arg, ref in zip(("x", "dt", "A", "B", "C", "D", "h0"), t, refs):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def test_gradcheck_carried_state_fn_fp64():
    """The plain carried-state pair in fp64 passes autograd's numerical
    gradient check with respect to every input, h0 included (L = 21: a
    full chunk and a 5-step tail; both outputs feed the check)."""
    x, dt, A, B, C, _, h0, _, _ = _scan_inputs(13, batch=1, length=21, d_inner=3,
                                               state_dim=3, dtype=np.float64)
    args = _torch(x, dt, A, B, C, h0, grad=True)
    assert torch.autograd.gradcheck(tscan.CarriedStateScanFn.apply, args, eps=1e-6, atol=1e-6)


def test_two_carried_chunks_match_one():
    """[0, 60) as two chunks of 30 with the carried state against one
    chunk: the gradients of a loss on y and h_final agree within 1e-6 of
    each gradient's max|grad| (dA and dD sum the two chunks' parts, in
    another order than one chunk's; the others agree bit for bit)."""
    x, dt, A, B, C, D, h0, _, _ = _scan_inputs(17, length=60, state_dim=8)
    rng = np.random.default_rng(18)
    wy = torch.tensor(rng.standard_normal(x.shape).astype(np.float32))
    wh = torch.tensor(rng.standard_normal(h0.shape).astype(np.float32))

    def grads(split):
        t = _torch(x, dt, A, B, C, D, h0, grad=True)
        h, ys = t[6], []
        for sl in ((slice(0, 30), slice(30, 60)) if split else (slice(0, 60),)):
            y, h = tscan.selective_scan(*(a[:, sl] for a in t[:2]), t[2],
                                        *(a[:, sl] for a in t[3:5]), t[5], mode="pallas",
                                        h0=h, return_state=True)
            ys.append(y)
        ((wy * torch.cat(ys, 1)).sum() + (wh * h).sum()).backward()
        return [a.grad for a in t]

    for name, a, b in zip(("x", "dt", "A", "B", "C", "D", "h0"), grads(True), grads(False)):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name


def test_carried_state_scan_keeps_the_inference_kernel_without_grad(monkeypatch):
    """Under no_grad the streaming scan runs scan_fwd_state (no bounds);
    under grad CarriedStateScanFn runs the bounds forward and, in the
    backward, the carried-state backward."""
    x, dt, A, B, C, D, h0, _, _ = _scan_inputs(21)
    calls = []
    for name in ("scan_fwd_state", "scan_fwd_bounds_state", "scan_bwd_state"):
        fn = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    t = _torch(x, dt, A, B, C, D, grad=True)
    with torch.no_grad():
        tscan.selective_scan(*t, mode="pallas", h0=torch.tensor(h0), return_state=True)
    assert calls == ["scan_fwd_state"]
    y, h = tscan.selective_scan(*t, mode="pallas", h0=torch.tensor(h0), return_state=True)
    h.sum().backward()  # y unused: its cotangent is zeros
    assert calls[1:] == ["scan_fwd_bounds_state", "scan_bwd_state"]
    assert t[0].grad is not None and t[0].grad.abs().max() > 0


# ----- mel normalisation ---------------------------------------------------------


@pytest.mark.parametrize("t,chunk", [(150, 64), (97, 20)])
def test_normalize_mel_matches_jax(t, chunk):
    rng = np.random.default_rng(t)
    mel = (rng.standard_normal((3, t, 80)) * 2.0 - 5.0).astype(np.float32)
    n_valid = np.array([t - 11, t, chunk // 2], np.int32)
    causal = taudio.causal_normalize_mel(torch.tensor(mel), torch.tensor(n_valid), chunk)
    ref = jaudio.causal_normalize_mel(jnp.asarray(mel), jnp.asarray(n_valid), chunk)
    np.testing.assert_allclose(causal.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    masked = taudio.masked_normalize_mel(torch.tensor(mel), torch.tensor(n_valid))
    ref = jaudio.masked_normalize_mel(jnp.asarray(mel), jnp.asarray(n_valid))
    np.testing.assert_allclose(masked.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert not causal[0, t - 11:].any() and not causal[2, chunk // 2:].any()
    # the last chunk of a full row has the whole row's statistics
    last = (t - 1) // chunk * chunk
    torch.testing.assert_close(causal[1, last:], masked[1, last:], rtol=1e-4, atol=1e-4)


# ----- streaming_forward ----------------------------------------------------------


@pytest.fixture(scope="module")
def stream_pair():
    """A JAX model (its sequential oracle scan) and the port's (the kernel
    path) with the same perturbed weights."""
    jm = jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **SMALL))
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, CHUNK, 80)))["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(p.shape)).astype(np.float32),
        jax.device_get(params))
    port = tmodel.create_model(VelocityASRConfig(scan_mode="pallas", **SMALL), device="cpu")
    port.load_state_dict(params_from_numpy(params), strict=True)
    return jm, params, port


def _grad_tree(model, grads):
    """Gradients laid out as the flax parameter tree (written into a copy
    of the model's parameters, then read out)."""
    clone = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads):
            p.copy_(g)
    return dict(_flatten(params_to_numpy(clone)))


def test_streaming_forward_matches_jax(stream_pair):
    jm, params, port = stream_pair
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 3 * CHUNK, 80)).astype(np.float32)
    w = rng.standard_normal((2, 3 * CHUNK // 2, 30)).astype(np.float32)

    def jloss(p, m):
        return jnp.sum(jnp.asarray(w) * jstream.streaming_forward(jm, p, m, CHUNK))

    ref = jstream.streaming_forward(jm, params, jnp.asarray(mel), CHUNK)
    ref_gp, ref_gm = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(mel))
    port.train()  # dropout 0: the training graph, carried state in autograd
    mel_t = torch.tensor(mel, requires_grad=True)
    logits = tstream.streaming_forward(port, mel_t, CHUNK, rng=torch.Generator())
    assert logits.shape == (2, 3 * CHUNK // 2, 30)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    params_t = list(port.parameters())
    grads = torch.autograd.grad((torch.tensor(w) * logits).sum(), [mel_t] + params_t)
    port.eval()

    def close(ours, theirs, what, scale=None):
        scale = scale or np.abs(theirs).max()
        assert np.abs(ours - theirs).max() <= 1e-4 * scale, what

    close(grads[0].numpy(), np.asarray(ref_gm), "mel")
    ours = _grad_tree(port, grads[1:])
    theirs = dict(_flatten(jax.device_get(ref_gp)))
    assert set(ours) == set(theirs)
    top = max(np.abs(v).max() for v in theirs.values())
    for key, ref_g in theirs.items():
        exact_zero = np.abs(ref_g).max() <= 1e-6 * top  # the key projection's bias
        close(ours[key], ref_g, key, top if exact_zero else None)
    with pytest.raises(AssertionError):
        tstream.streaming_forward(port, torch.zeros(1, CHUNK + 2, 80), CHUNK)


# ----- device-mel data ------------------------------------------------------------


def _assert_same_batch(ours, ref):
    assert set(ours) == set(ref)
    for key in ours:
        if key == "texts":
            assert ours[key] == ref[key]
        else:
            assert ours[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_synth_device_mel_items_and_collation_equal_jax():
    kw = dict(split="train", seed=1234, max_words=40, device_mel=True)
    ours, ref = tsynth.SyntheticSpeechDataset(2000, **kw), jsynth.SyntheticSpeechDataset(2000, **kw)
    items = []
    for idx in (0, 7, 1234):
        a, b = ref[idx], ours[idx]
        assert set(a) == set(b) == {"targets", "target_lengths", "text", "audio",
                                    "input_lengths"}
        for key in a:
            if key == "text":
                assert a[key] == b[key]
            else:
                assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert b["input_lengths"] == 1 + len(b["audio"]) // 160
        items.append(b)
    # a 1-sample clip takes the zero-padding branch, a loud one clips
    items.append(dict(items[0], audio=np.array([0.5], np.float32), input_lengths=np.int32(1)))
    items.append(dict(items[1], audio=items[1]["audio"] * 40.0))
    for bucket in (600, 1):
        batch = tdata.ASRCollator(frame_bucket=bucket)(items)
        _assert_same_batch(batch, jdata.ASRCollator(frame_bucket=bucket)(items))
        assert batch["audio"].dtype == np.int16
        assert (batch["audio"].shape[1] // 160 + 1) % bucket == 0


def test_manifest_device_mel_items_and_workers(tmp_path):
    """ASRDataset(device_mel=True) items equal the JAX package's, and the
    loader's worker processes hand the int16 PCM over as it is."""
    manifest = tsynth.write_corpus(str(tmp_path), 3, split="test", seed=1234)
    kw = dict(max_duration=None, min_duration=0.0, device_mel=True)
    ours, ref = tdata.ASRDataset(manifest, **kw), jdata.ASRDataset(manifest, **kw)
    for i in range(3):
        a, b = ref[i], ours[i]
        assert set(a) == set(b) and "mel_spectrogram" not in b
        for key in ("audio", "input_lengths", "targets", "target_lengths"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with pytest.raises(ValueError, match="normalize_audio=False"):
        tdata.ASRDataset(manifest, normalize_audio=False, **kw)
    collator = tdata.ASRCollator(frame_bucket=200)
    loader = tdata.DataLoader(ours, batch_size=3, shuffle=False, num_workers=1,
                              collate_fn=collator)
    batch = next(iter(loader))
    assert batch["audio"].dtype == np.int16
    _assert_same_batch(batch, collator([ours[i] for i in range(3)]))


# ----- the streaming-aware objective -------------------------------------------------


def _audio_batch(seed, samples=(150 * 160 + 37, 120 * 160 + 5), target_lengths=(10, 7)):
    """A device-mel batch of random audio: 3 chunks of CHUNK frames."""
    rng = np.random.default_rng(seed)
    items = [{"audio": (rng.standard_normal(n) * 0.1).astype(np.float32),
              "targets": rng.integers(3, 30, k).astype(np.int32),
              "target_lengths": np.int32(k), "input_lengths": np.int32(1 + n // 160),
              "text": ""} for n, k in zip(samples, target_lengths)]
    batch = tdata.ASRCollator(frame_bucket=CHUNK)(items)
    assert 1 + batch["audio"].shape[1] // 160 == 3 * CHUNK
    return batch


def _small_model(seed=1, **overrides):
    cfg = VelocityASRConfig(**{**SMALL, "scan_mode": "pallas", **overrides})
    return tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def test_stream_update_matches_jax_trainer():
    """One update on a device-mel batch with streaming_chunks: the port's
    loss and weights against the JAX Trainer's (its sequential oracle
    scan; the Pallas launchers are held above), from the same weights."""
    batch = _audio_batch(1)
    port = _small_model()
    params = params_to_numpy(port)
    kw = dict(learning_rate=1e-3, warmup_steps=2, max_steps=4, grad_clip_norm=1.0,
              weight_decay=0.01, log_interval=100, streaming_chunks=CHUNK,
              streaming_aux_weight=0.5)
    jt = jtraining.Trainer(
        jmodel.create_model(jconfig.VelocityASRConfig(scan_mode="sequential", **SMALL)),
        jtraining.TrainingConfig(**kw), iter([batch]), params=params)
    tt = ttraining.Trainer(port, ttraining.TrainingConfig(**kw), iter([batch]))
    ref, ours = jt.train_step(batch), tt.train_step(batch)
    np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
    # the gradient the update took, for the weight comparison below
    check = _small_model()
    trainer = ttraining.Trainer(check, ttraining.TrainingConfig(**kw), iter(()))
    check.train()
    grads = _grad_tree(check, torch.autograd.grad(
        trainer._loss(trainer._to_device(batch), None), list(check.parameters())))
    start = dict(_flatten(params))
    jax_after = dict(_flatten(jax.device_get(jt.params)))
    port_after = dict(_flatten(params_to_numpy(tt.model)))
    lr = tt.optimizer.last_lr()
    covered = total = 0
    for key, ref_w in jax_after.items():
        ours_w = port_after[key]
        assert np.abs(ours_w - start[key]).max() > 0 or not np.abs(grads[key]).max(), key
        assert np.abs(ours_w - ref_w).max() <= 2 * lr, key
        big = np.abs(grads[key]) > 3e-5
        np.testing.assert_allclose(ours_w[big], ref_w[big], rtol=0, atol=1e-6, err_msg=str(key))
        covered += big.sum()
        total += big.size
    assert covered > 0.75 * total


def test_spec_augment_masks_both_views_alike(monkeypatch):
    """With SpecAugment on, the streaming view is masked by the same draws
    as the offline view: the masks of both calls are equal (and not
    empty), and the dropout draws go on from the step's generator."""
    masks = []
    real = ttraining.spec_augment

    def recording(mel, rng, cfg, lengths):
        probe = torch.Generator(device=rng.device)
        probe.set_state(rng.get_state())
        masks.append(real(torch.ones_like(mel), probe, cfg, lengths) == 0)
        return real(mel, rng, cfg, lengths)

    monkeypatch.setattr(ttraining, "spec_augment", recording)
    aug = taugment.SpecAugmentConfig(enabled=True, num_time_masks=2, time_mask_frames=20,
                                     num_freq_masks=2, freq_mask_bins=10)
    trainer = ttraining.Trainer(_small_model(dropout=0.1),
                                ttraining.TrainingConfig(streaming_chunks=CHUNK, augment=aug,
                                                         warmup_steps=1), iter(()))
    out = trainer.train_step(_audio_batch(2))
    assert np.isfinite(out["loss"])
    assert len(masks) == 2 and masks[0].any() and torch.equal(masks[0], masks[1])


def test_eval_step_adds_the_streaming_term(monkeypatch):
    """eval_step on a device-mel batch: (1 - w) * offline + w * streaming,
    the streaming term through the inference scan (no bounds)."""
    batch = _audio_batch(3)
    model = _small_model(seed=5)

    def eval_loss(**kw):
        cfg = ttraining.TrainingConfig(**kw)
        return ttraining.Trainer(model, cfg, iter(()), seed=0).eval_step(batch)["eval_loss"]

    offline = eval_loss()
    streaming = eval_loss(streaming_chunks=CHUNK, streaming_aux_weight=1.0)
    calls = []
    fn = tscan.scan_fwd_state
    monkeypatch.setattr(tscan, "scan_fwd_state", lambda *a: calls.append(1) or fn(*a))
    mixed = eval_loss(streaming_chunks=CHUNK, streaming_aux_weight=0.25)
    assert streaming != offline
    assert mixed == pytest.approx(0.75 * offline + 0.25 * streaming, rel=1e-6)
    assert len(calls) == 3 * 3  # 3 chunks x (2 local + 1 global) blocks
    # a host-mel batch has no raw mel: evaluation keeps the offline loss
    # (training raises, test_torch_training's test_unported_options_raise)
    mel, _ = ttraining.Trainer._batch_mel(
        {k: torch.as_tensor(batch[k]) for k in ("audio", "input_lengths")})
    host = {"mel_spectrogram": mel.numpy(),
            **{k: batch[k] for k in ("targets", "input_lengths", "target_lengths")}}
    cfg = ttraining.TrainingConfig(streaming_chunks=CHUNK)
    host_loss = ttraining.Trainer(model, cfg, iter(()), seed=0).eval_step(host)["eval_loss"]
    assert host_loss == pytest.approx(offline, rel=1e-6)


def _write_yaml(path, text):
    path.write_text(text)
    return str(path)


SMALL_MODEL_YAML = (
    "model:\n  d_model: 32\n  dropout: 0.1\nssm:\n  num_layers: 2\n  state_dim: 8\n"
    "global_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n  attention_dim: 16\n"
    "output:\n  vocab_size: 1000\nperformance:\n  scan_mode: pallas\n")


@pytest.mark.parametrize("switch", ["noise_injection", "speed_perturb"])
def test_waveform_augmentation_with_device_mel_raises(tmp_path, switch):
    """noise_injection and speed_perturb on device-mel batches are ported:
    the CLI takes a step with either switch on the streaming recipe
    (nothing raises) and logs a finite loss (logged every micro-step)."""
    text = open(STREAM_YAML).read().replace("  enabled: true\n",
                                             f"  enabled: true\n  {switch}: true\n")
    assert text.count("  log_interval: 50\n") == 1
    text = text.replace("  log_interval: 50\n", "  log_interval: 1\n")
    config = _write_yaml(tmp_path / "train.yaml", text)
    model = _write_yaml(tmp_path / "model.yaml", SMALL_MODEL_YAML)
    out = ttrain.main(["--config", config, "--model-config", model, "--synthetic", "8",
                       "--max-steps", "1", "--num-workers", "0", "--device", "cpu",
                       "--checkpoint-dir", str(tmp_path / "run")])
    aug = out["trainer"].config.augment
    assert getattr(aug, switch) and aug.enabled
    assert out["trainer"].global_step == 1
    losses = out["history"]["train_loss"]
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_stream_recipe_maps_as_jax():
    """configs/train_synth_stream.yaml: the training mapping equals the JAX
    package's (streaming_chunks 200, weight 0.5), and build_data serves
    raw audio with the recipe's bucket and word counts."""
    train = tyaml.load_yaml(STREAM_YAML)
    ours = tyaml.training_config_from_yaml(train)
    assert dataclasses.asdict(ours) == dataclasses.asdict(jyaml.training_config_from_yaml(train))
    assert (ours.streaming_chunks, ours.streaming_aux_weight) == (200, 0.5)
    data = dict(train["data"], synthetic=16)
    train_loader, eval_loader, vocab = ttrain.build_data(data, 2, 0)
    ds = train_loader.dataset
    assert (ds.device_mel, ds.max_words, ds.min_words) == (True, 40, 2)
    assert train_loader.collate_fn.frame_bucket == eval_loader.collate_fn.frame_bucket == 600
    assert eval_loader.dataset.device_mel and len(vocab) == 30


def test_cli_two_stream_steps_on_cpu(tmp_path):
    """python -m velocity_asr_tpu_torch.train on the streaming recipe
    (device_mel, streaming_chunks 200) for 2 steps on the CPU at a small
    width, with up to 8 words per utterance (the recipe's 40 make 28 s
    clips, 14 chunks, too slow for a unit test)."""
    text = open(STREAM_YAML).read().replace("synthetic_max_words: 40", "synthetic_max_words: 8")
    config = _write_yaml(tmp_path / "train.yaml", text)
    model = _write_yaml(tmp_path / "model.yaml", SMALL_MODEL_YAML)
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "velocity_asr_tpu_torch.train", "--config", config,
         "--model-config", model, "--synthetic", "4", "--max-steps", "2", "--batch-size", "2",
         "--checkpoint-dir", str(out), "--num-workers", "0", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    meta = __import__("json").load(open(out / "final_model" / "trainer_meta.json"))
    assert meta["global_step"] == 2
    assert meta["training_config"]["streaming_chunks"] == 200
    assert tmodel.from_pretrained(str(out / "final_pretrained"), device="cpu").config.d_model == 32
