"""The port's parallel entry points on the CPU: the train and
``transcribe --sequence-parallel`` CLIs under torchrun (gloo, world 2,
``--device cpu``) against one process, the train CLI also with QAT."""

import json
import os
import subprocess
import sys

import pytest
import torch


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _torchrun(args, world=2):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(world)] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=300, env=env)


def test_train_cli_under_torchrun_matches_one_process(tmp_path):
    (tmp_path / "model.yaml").write_text(
        "model:\n  d_model: 32\n  dropout: 0.0\nssm:\n  num_layers: 2\n  state_dim: 8\n"
        "global_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n  attention_dim: 16\n"
        "output:\n  vocab_size: 1000\nperformance:\n  scan_mode: pallas\n")
    train = open(os.path.join(ROOT, "configs", "train_synth.yaml")).read()
    (tmp_path / "train.yaml").write_text(train.replace("gradient_accumulation_steps: 2",
                                                       "gradient_accumulation_steps: 1"))
    common = ["--config", str(tmp_path / "train.yaml"), "--model-config",
              str(tmp_path / "model.yaml"), "--synthetic", "8", "--max-steps", "2",
              "--batch-size", "4", "--num-workers", "0", "--device", "cpu"]
    proc = _torchrun(["-m", "velocity_asr_tpu_torch.train", *common, "--checkpoint-dir",
                      str(tmp_path / "world2")])
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "velocity_asr_tpu_torch.train", *common,
                          "--checkpoint-dir", str(tmp_path / "one")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert one.returncode == 0, one.stderr[-3000:]
    from velocity_asr_tpu_torch.models.model import from_pretrained

    a = from_pretrained(str(tmp_path / "world2" / "final_pretrained"), device="cpu")
    b = from_pretrained(str(tmp_path / "one" / "final_pretrained"), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        # two Adam updates at lr <= 3e-4 * 2 / 500: a near-zero gradient may flip
        assert (p - q).abs().max().item() <= 2 * 2 * 3e-4 * 2 / 500, name
    assert open(tmp_path / "world2" / "final_pretrained" / "vocabulary.json").read() == \
        open(tmp_path / "one" / "final_pretrained" / "vocabulary.json").read()


def test_train_cli_qat_under_torchrun_matches_one_process(tmp_path):
    """quantization.enabled under torchrun at world 2: the observers range
    over the global batch, so final_pretrained's quant_stats.msgpack
    (written once every rank has gathered) and params are the one-process
    run's, within tests/test_torch_quantize.py's stats tolerances and the
    update bound above."""
    from test_torch_quantize import ACT_STATS_RTOL, JIT_WEIGHT_RTOL, _check_stats
    from velocity_asr_tpu_torch.checkpoint import quant_stats_from_numpy, read_params
    from velocity_asr_tpu_torch.models.model import create_model, from_pretrained
    from velocity_asr_tpu_torch.quantize import load_quant_stats, prepare_model_for_qat

    (tmp_path / "model.yaml").write_text(
        "model:\n  d_model: 16\n  dropout: 0.0\nssm:\n  num_layers: 1\n  state_dim: 4\n"
        "global_context:\n  ssm_layers: 1\n  ssm_state_dim: 4\n  attention_heads: 2\n"
        "  attention_dim: 8\noutput:\n  vocab_size: 1000\nperformance:\n  scan_mode: pallas\n")
    train = open(os.path.join(ROOT, "configs", "train_synth.yaml")).read()
    (tmp_path / "train.yaml").write_text(
        train.replace("gradient_accumulation_steps: 2", "gradient_accumulation_steps: 1")
        .replace("quantization:\n  enabled: false", "quantization:\n  enabled: true"))
    common = ["--config", str(tmp_path / "train.yaml"), "--model-config",
              str(tmp_path / "model.yaml"), "--synthetic", "8", "--max-steps", "2",
              "--batch-size", "4", "--num-workers", "0", "--device", "cpu"]
    proc = _torchrun(["-m", "velocity_asr_tpu_torch.train", *common, "--checkpoint-dir",
                      str(tmp_path / "world2")])
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "velocity_asr_tpu_torch.train", *common,
                          "--checkpoint-dir", str(tmp_path / "one")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert one.returncode == 0, one.stderr[-3000:]
    world2, ref = (tmp_path / run / "final_pretrained" for run in ("world2", "one"))
    a, b = (from_pretrained(str(d), device="cpu") for d in (world2, ref))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert (p - q).abs().max().item() <= 2 * 2 * 3e-4 * 2 / 500, name
    model = create_model(prepare_model_for_qat(b.config), device="cpu")
    load_quant_stats(model, quant_stats_from_numpy(read_params(str(ref / "quant_stats.msgpack"))))
    _check_stats(read_params(str(world2 / "quant_stats.msgpack")), model, ACT_STATS_RTOL,
                 JIT_WEIGHT_RTOL)


def test_transcribe_sequence_parallel_under_torchrun_matches_one_process(tmp_path):
    from velocity_asr_tpu_torch import synth

    manifest = synth.write_corpus(str(tmp_path / "utts"), 2)
    files = [json.loads(line)["audio_path"] for line in open(manifest)]
    ckpt = os.path.join(ROOT, "checkpoints", "synth_run", "final_pretrained")
    args = ["-m", "velocity_asr_tpu_torch.transcribe", *files, "--checkpoint", ckpt,
            "--device", "cpu", "--json"]
    proc = _torchrun(args + ["--sequence-parallel", "--output", str(tmp_path / "sp.json")])
    assert proc.returncode == 0, proc.stderr[-3000:]
    one = subprocess.run([sys.executable] + args + ["--output", str(tmp_path / "one.json")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert one.returncode == 0, one.stderr[-3000:]
    sp = json.load(open(tmp_path / "sp.json"))
    ref = json.load(open(tmp_path / "one.json"))
    assert [r["text"] for r in sp] == [r["text"] for r in ref]
    assert all(r["text"] for r in ref)
