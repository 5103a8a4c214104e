"""The PyTorch port imports neither JAX, flax, msgpack, optax, PyYAML nor the
JAX package."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "velocity_asr_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "optax", "yaml", "velocity_asr_tpu"}


def _port_files():
    out = []
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def _modules():
    names = []
    for path in _port_files()[:-1]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        names.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = {node.module.split(".")[0]}
        else:
            continue
        assert not roots & FORBIDDEN, f"{path}:{node.lineno} imports {roots & FORBIDDEN}"


@pytest.mark.parametrize("module", [
    "velocity_asr_tpu_torch.data", "velocity_asr_tpu_torch.evaluate",
    "velocity_asr_tpu_torch.ops.int8_matmul", "velocity_asr_tpu_torch.quantize",
    "velocity_asr_tpu_torch.training",
])
def test_batched_int8_modules_are_checked(module):
    """The evaluation and int8 modules are among those both checks above
    and below walk."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "velocity_asr_tpu_torch.augment", "velocity_asr_tpu_torch.config",
    "velocity_asr_tpu_torch.train", "velocity_asr_tpu_torch.training",
    "velocity_asr_tpu_torch.synth", "velocity_asr_tpu_torch.checkpoint",
    "velocity_asr_tpu_torch.ops.scan", "velocity_asr_tpu_torch.models.model",
])
def test_training_modules_are_checked(module):
    """The training modules are among those both checks walk."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "velocity_asr_tpu_torch.streaming", "velocity_asr_tpu_torch.audio",
    "velocity_asr_tpu_torch.data", "velocity_asr_tpu_torch.ops.mel",
    "velocity_asr_tpu_torch.ops.cuda_lib",
])
def test_stream_training_modules_are_checked(module):
    """The modules of the streaming-aware objective (streaming_forward,
    the device mel and its normalisations, the device-mel data, the
    carried-state kernels' bindings) are among those both checks walk."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "velocity_asr_tpu_torch.beam", "velocity_asr_tpu_torch.lm",
    "velocity_asr_tpu_torch.hotwords", "velocity_asr_tpu_torch.train_lm",
    "velocity_asr_tpu_torch.decode",
])
def test_beam_search_modules_are_checked(module):
    """The beam search, the n-gram LM, the hot-word booster and the LM
    build are among the modules both checks walk."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "velocity_asr_tpu_torch.serve", "velocity_asr_tpu_torch.transcribe",
])
def test_serving_modules_are_checked(module):
    """The HTTP server and the offline transcriber behind it are among the
    modules both checks walk."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "velocity_asr_tpu_torch.io", "velocity_asr_tpu_torch.data",
    "velocity_asr_tpu_torch.train", "velocity_asr_tpu_torch.training",
    "velocity_asr_tpu_torch.augment", "velocity_asr_tpu_torch.models.ssm",
    "velocity_asr_tpu_torch.evaluate", "velocity_asr_tpu_torch.synth",
    "velocity_asr_tpu_torch.parity_run",
])
def test_data_source_modules_are_checked(module):
    """The native decoding, the data sources (LibriSpeech, manifests,
    dummy data), the waveform augmentation, gradient checkpointing, the
    profiler window and the parity run are among the modules both checks
    walk."""
    assert module in _modules()


def test_native_decoding_reads_only_the_repo_sources():
    """The port builds its decoders from native/*.cc into its own _build/,
    and names neither the JAX package's library directory nor the
    Makefile's build directory."""
    with open(os.path.join(PKG, "io.py")) as f:
        text = f.read()
    assert '"_native"' not in text and "_native/" not in text
    assert '"build"' not in text and "native/build" not in text and "make -C" not in text


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
