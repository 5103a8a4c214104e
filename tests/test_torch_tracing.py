"""The port's named host spans (``velocity_asr_tpu_torch.tracing``): none
without a profiler, and under one each stage's span in its order, once
a frame bucket, a step or an MoE layer. Tiny models on the CPU."""

import numpy as np
import pytest
import torch

from velocity_asr_tpu_torch import data as tdata
from velocity_asr_tpu_torch import tracing
from velocity_asr_tpu_torch import training as ttraining
from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
from velocity_asr_tpu_torch.models import model as tmodel
from velocity_asr_tpu_torch.models import moe as tmoe
from velocity_asr_tpu_torch.models.config import VelocityASRConfig
from velocity_asr_tpu_torch.transcribe import Transcriber

SMALL = dict(d_model=16, ssm_layers=2, ssm_state_dim=4, global_ssm_layers=1,
             global_ssm_state_dim=4, attention_heads=2, attention_dim=8, vocab_size=30,
             dropout=0.1, scan_mode="pallas", dtype="float32")
TRANSCRIBE = ["transcribe.pad", "transcribe.wire", "transcribe.h2d", "transcribe.forward",
              "transcribe.fetch", "transcribe.text"]
TRAIN = ["train.h2d", "train.forward", "train.ctc", "train.backward", "train.optimizer",
         "train.fetch"]
MOE = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: under xdist the workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(**overrides):
    cfg = VelocityASRConfig(**{**SMALL, **overrides})
    return tmodel.create_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def _audios():
    """Three utterances over two 100-frame buckets: 100, 100, 200 frames."""
    rng = np.random.default_rng(5)
    return [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (8000, 12000, 24000)]


def _transcriber(model):
    return Transcriber(model, CTCDecoder(create_default_vocabulary(30)), frame_bucket=100)


def _train_items():
    rng = np.random.default_rng(6)
    items = []
    for a in _audios():
        tgt = rng.integers(3, 30, 6).astype(np.int32)
        items.append({"audio": a, "targets": tgt, "input_lengths": np.int32(1 + len(a) // 160),
                      "target_lengths": np.int32(len(tgt))})
    return items


def _trainer(model):
    cfg = ttraining.TrainingConfig(max_steps=10, warmup_steps=1, batch_size=3)
    return ttraining.Trainer(model, cfg, iter(()), seed=0)


def _spans(prof, prefix):
    """(name, start, end) of the profiled ranges whose names start with
    `prefix`, in order of their start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(prefix)]
    return sorted(out, key=lambda e: (e[1], -e[2]))


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _disjoint(spans):
    return all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    """No profiler records: every span is the one null context and no
    call of the entry, the collator, the trainer or the MoE layer makes
    a ``record_function``."""
    made = []

    def record(name):
        made.append(name)
        raise AssertionError(f"record_function({name!r}) without a profiler")

    assert tracing.span("transcribe.pad") is tracing.span("moe.route")
    with _profile():
        assert isinstance(tracing.span("moe.route"), torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", record)
    assert not torch._C._autograd._profiler_enabled()
    model = _model(moe_experts=4, moe_top_k=2)
    assert len(_transcriber(model).transcribe_batch(_audios())) == 3
    batch = tdata.ASRCollator(frame_bucket=100)(_train_items())
    assert np.isfinite(_trainer(model).train_step(batch)["loss"])
    assert made == []


def test_transcribe_batch_spans_each_stage_once_a_bucket():
    transcriber = _transcriber(_model())
    with _profile() as prof:
        out = transcriber.transcribe_batch(_audios())
    assert len(out) == 3
    spans = _spans(prof, "transcribe.")
    assert [s[0] for s in spans] == TRANSCRIBE * 2
    assert _disjoint(spans)


def test_train_step_spans_each_stage_once_and_collation():
    """One collation and one ``train_step``: ``data.collate`` once, each
    ``train.*`` span once in order, ``train.clip`` inside
    ``train.optimizer``."""
    trainer = _trainer(_model())
    with _profile() as prof:
        batch = tdata.ASRCollator(frame_bucket=100)(_train_items())
        assert np.isfinite(trainer.train_step(batch)["loss"])
    assert [s[0] for s in _spans(prof, "data.")] == ["data.collate"]
    spans = _spans(prof, "train.")
    clip = [s for s in spans if s[0] == "train.clip"]
    rest = [s for s in spans if s[0] != "train.clip"]
    assert [s[0] for s in rest] == TRAIN and _disjoint(rest)
    assert len(clip) == 1
    opt = rest[TRAIN.index("train.optimizer")]
    assert opt[1] <= clip[0][1] and clip[0][2] <= opt[2]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_moe_forward_spans_each_stage_once_a_layer(train):
    model = _model(moe_experts=4, moe_top_k=2)
    layers = [m for m in model.modules() if isinstance(m, tmoe.MoEFFN)]
    assert len(layers) == 2
    model.train(train)
    mel = torch.randn(2, 120, 80)
    rng = torch.Generator().manual_seed(1) if train else None
    with _profile() as prof, torch.set_grad_enabled(train):
        model(mel, rng=rng)
    spans = _spans(prof, "moe.")
    assert [s[0] for s in spans] == MOE * len(layers)
    assert _disjoint(spans)


def test_moe_spans_nest_inside_the_entrys_forward():
    transcriber = _transcriber(_model(moe_experts=4, moe_top_k=2))
    with _profile() as prof:
        transcriber.transcribe_batch(_audios()[:1])
    forward = [s for s in _spans(prof, "transcribe.") if s[0] == "transcribe.forward"]
    moe = _spans(prof, "moe.")
    assert len(forward) == 1 and len(moe) == 2 * len(MOE)
    assert all(forward[0][1] <= s[1] and s[2] <= forward[0][2] for s in moe)
