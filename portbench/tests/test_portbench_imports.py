"""What the benchmark loads, and the reference held against the port's
plain path at a tiny size on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "velocity_asr_tpu")

TINY = dict(mel_bins=80, d_model=32, ssm_layers=2, ssm_state_dim=8, ssm_expand_ratio=2,
            ssm_kernel_size=4, global_ssm_layers=1, global_ssm_state_dim=4,
            attention_heads=4, attention_dim=16, vocab_size=40, dropout=0.1,
            scan_mode="parallel", dtype="float32", moe_experts=0)


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after `code`."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runs_import_path_loads_no_jax():
    top = loaded_after(
        "import glob, os\n"
        "from portbench import run, control, generator, counts, trace\n"
        "from portbench.entries import offline\n"
        "import velocity_asr_tpu_torch.transcribe, velocity_asr_tpu_torch.training\n"
        "import velocity_asr_tpu_torch.decode, velocity_asr_tpu_torch.models.model\n"
        "for p in sorted(glob.glob('portbench/metrics/*.py')):\n"
        "    if not p.endswith('__init__.py'):\n"
        "        run.reader(os.path.basename(p)[:-3])\n"
        "import portbench.entries, pkgutil\n"
        "for m in pkgutil.iter_modules(portbench.entries.__path__):\n"
        "    __import__('portbench.entries.' + m.name)\n")
    assert "velocity_asr_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_reference_loads_neither_jax_nor_the_port():
    top = loaded_after("import portbench.reference.model, portbench.reference.frontend, "
                       "portbench.reference.judge\n"
                       "import pkgutil, portbench.reference\n"
                       "for m in pkgutil.iter_modules(portbench.reference.__path__):\n"
                       "    __import__('portbench.reference.' + m.name)\n")
    assert not top & set(FORBIDDEN + ("velocity_asr_tpu_torch",))


def port_model(keys, params):
    from velocity_asr_tpu_torch.models.config import VelocityASRConfig
    from velocity_asr_tpu_torch.models.model import VelocityASR

    with torch.device("meta"):
        model = VelocityASR(VelocityASRConfig.from_dict(keys))
    model = model.to_empty(device="cpu")
    model.load_state_dict(params, strict=True)
    return model.eval()


@pytest.mark.parametrize("extra", [{}, {"moe_experts": 4, "moe_top_k": 2,
                                        "moe_capacity_factor": 1.25}])
@pytest.mark.parametrize("frames", [64, 600])
def test_reference_matches_the_ports_plain_path(extra, frames):
    from portbench.reference import model as reference

    torch.set_num_threads(2)
    keys = {**TINY, **extra}
    params = reference.make_params(keys, 5, "cpu")
    mel = torch.randn(3, frames, 80, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = port_model(keys, params)(mel)
        got = reference.forward(params, keys, mel)
    assert got.shape == want.shape == (3, (frames + 1) // 2, 40)
    assert (got - want).abs().max().item() < 1e-4 * max(1.0, want.abs().max().item())


def test_reference_dropout_draws_as_the_port_does():
    from portbench.reference import model as reference

    keys = dict(TINY)
    params = reference.make_params(keys, 6, "cpu")
    model = port_model(keys, params).train()
    mel = torch.randn(2, 100, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(mel, rng=torch.Generator().manual_seed(9))
        got = reference.forward(params, keys, mel, rng=torch.Generator().manual_seed(9))
        plain = reference.forward(params, keys, mel)
    assert (got - want).abs().max().item() < 1e-4
    assert (plain - want).abs().max().item() > 1e-2   # the masks do change the output


def test_reference_front_end_matches_the_ports():
    from velocity_asr_tpu_torch.audio import masked_normalize_mel
    from velocity_asr_tpu_torch.ops.mel import compute_mel_spectrogram

    from portbench import generator
    from portbench.reference import frontend

    rng = np.random.default_rng(3)
    pcms = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (31000, 28000, 20801)]
    frames = 200
    want_in = np.stack([frontend.padded_pcm(p, frames) for p in pcms])
    audio = torch.tensor(want_in.astype(np.float32) / 32768.0)
    raw = compute_mel_spectrogram(audio, normalize=False)
    n_valid = torch.tensor([frontend.valid_frames(len(p)) for p in pcms])
    want = masked_normalize_mel(raw, n_valid)
    got = frontend.normalized_mel(pcms, frames, "cpu")
    assert generator.bucket_frames(31000, 200) == frames
    assert (got - want).abs().max().item() < 2e-3


def test_texts_parse_back_to_token_ids():
    from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary

    from portbench.reference import frontend

    vocab = frontend.default_vocabulary(1000)
    assert vocab == create_default_vocabulary(1000)
    dec = CTCDecoder(vocab)
    ids = [5, 3, 999, 1, 2, 60, 3, 3, 400]
    assert frontend.text_to_ids(dec.tokens_to_text(ids), vocab) == ids
    assert frontend.text_to_ids(dec.tokens_to_text([3, 7, 3]), vocab) == [7]
    assert frontend.text_to_ids("a<nope>", vocab) is None


def test_reference_training_steps_match_the_ports_trainer():
    """Two steps of the recipe (SpecAugment, dropout, CTC, clip, AdamW) at
    fp32: the losses, the first clipped gradient and the parameters after."""
    import copy

    from portbench import generator, run
    from portbench.entries import train
    from portbench.reference import model as reference
    from portbench.reference import train as ref_train

    torch.set_num_threads(2)
    spec = copy.deepcopy(run.cell("base.train"))
    keys = {**spec["config"], **TINY}
    mix = {**spec["mix"], "batch": 3, "cycle": 2, "pool_s": 30, "target_ids": [1, 39],
           "lengths": {"mean_s": 1.5, "sigma_log": 0.35, "min_s": 0.5, "max_s": 3.0}}
    mix["recipe"] = {**mix["recipe"], "warmup_steps": 2}     # rates far from zero
    seed = 77
    trainer, collate = train.build_trainer(keys, mix, seed, "cpu")
    pool = generator.pcm_pool(mix, seed)
    shapes = generator.make_batches(mix, seed)
    calls = generator.place(shapes, len(pool), seed)
    tokens = generator.targets(mix, shapes, seed)
    losses, batches = [], []
    for i in range(2):
        rows = calls[i]["rows"]
        items = [{"audio": pool[o:o + n].astype(np.float32) / 32768.0, "targets": t,
                  "input_lengths": np.int32(1 + n // 160), "target_lengths": np.int32(len(t))}
                 for (o, n), t in zip(rows, tokens[i])]
        losses.append(trainer.train_step(collate(items))["loss"])
        if i == 0:
            first = [m / 0.1 for m in trainer.optimizer.mu]
        batches.append({"pcm": [pool[o:o + n] for o, n in rows], "frames": calls[i]["frames"],
                        "targets": train.pad_targets(tokens[i]),
                        "target_lengths": torch.tensor([len(t) for t in tokens[i]])})
    ref = ref_train.run_steps(reference.make_params(keys, seed, "cpu"), keys, mix["recipe"],
                              batches, seed)
    assert np.allclose(losses, ref["losses"], rtol=1e-4)
    names = [n for n, _ in trainer.model.named_parameters()]
    signed = {}
    for n, g in zip(names, first):
        tol = 1e-3 * ref["first_grad"][n].abs().max() + 1e-7
        assert (g - ref["first_grad"][n]).abs().max() <= tol
        signed[n] = ref["first_grad"][n].abs() > tol
    for n, p in trainer.model.named_parameters():
        # two updates of rate 5e-5 and 1e-4, each about a whole rate per
        # element: where the gradient's sign is fixed within the tolerance
        # above, hold each element within a tenth of a step; an element
        # whose gradient is nought to rounding (a key's bias under softmax)
        # may step either way, within the two rates
        gap = (p.detach() - ref["params"][n]).abs()
        assert bool((gap[signed[n]] < 1e-5).all())
        assert gap.max() <= 1.5e-4 + 1e-7
