"""The readers of the program's own spans (``portbench/spans.py`` and the
metrics that use it): synthetic traces, and a tiny program profiled on
the CPU through the harness's own reduction."""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from portbench import run, spans, trace

OFFLINE = {"host_prep_ms.offline": ("transcribe.pad", "transcribe.wire"),
           "h2d_ms.offline": ("transcribe.h2d",),
           "dispatch_ms.offline": ("transcribe.forward",),
           "text_ms.offline": ("transcribe.text",),
           "moe_ms.offline": ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")}
TRAIN = {"collate_ms.train": ("data.collate",),
         "dispatch_ms.train": ("train.h2d", "train.forward", "train.ctc", "train.backward",
                               "train.clip", "train.optimizer")}
STAGES = ("transcribe.pad", "transcribe.wire", "transcribe.h2d", "transcribe.forward",
          "transcribe.fetch", "transcribe.text")


def existing_readers():
    mine = set(OFFLINE) | set(TRAIN)
    names = (os.path.basename(p)[:-3] for p in glob.glob(os.path.join(run.HERE, "metrics", "*.py")))
    return sorted(n for n in names if n != "__init__" and n not in mine)


def offline_trace(host, n_calls=2):
    model = run.cell("base.offline")["config"]
    calls = [{"frames": 400, "rows": [30000] * 4}] * n_calls
    device = [("void scan_fwd_kernel<1, 16, false, false, false>(Params)", 0.1 * i, 0.1 * i + 0.01)
              for i in range(10 * n_calls)]
    device.append(("log_mel_kernel(float const*)", 0.95, 0.96))
    return trace.Trace("offline", model, calls, 2.0, device, host)


def program_spans(n_calls=2, buckets=2):
    """Each call a ``portbench.call`` of 1 s holding `buckets` passes over
    the entry's stages, one after another, each 10 ms, with one MoE
    layer's spans in each forward."""
    host = []
    for c in range(n_calls):
        host.append(("portbench.call", c * 1.0, c * 1.0 + 1.0))
        t = c * 1.0 + 0.01
        for _ in range(buckets):
            for stage in STAGES:
                host.append((stage, t, t + 0.01))
                if stage == "transcribe.forward":
                    host += [(name, t + 0.002 * i, t + 0.002 * i + 0.001)
                             for i, name in enumerate(OFFLINE["moe_ms.offline"])]
                t += 0.01
    return host


def test_a_reader_sums_repeated_spans_a_call():
    tr = offline_trace(program_spans())
    got = {name: run.reader(name).read(tr) for name in OFFLINE}
    # two buckets a call: each stage twice, 10 ms each
    assert math.isclose(got["host_prep_ms.offline"], 40.0)
    assert math.isclose(got["h2d_ms.offline"], 20.0)
    assert math.isclose(got["dispatch_ms.offline"], 20.0)
    assert math.isclose(got["text_ms.offline"], 20.0)
    assert math.isclose(got["moe_ms.offline"], 8.0)
    for name in OFFLINE:
        assert run.reader(name).LAYER == next(m["layer"] for m in run.load_json(
            run.ROOT, "BENCHMARK.json")["per_layer"] if m["name"] == name)


def test_a_span_inside_another_of_the_same_reader_counts_once():
    model = run.cell("base.train")["config"]
    calls = [{"frames": 2400, "rows": [380000] * 32}]
    host = [("portbench.call", 0.0, 0.5), ("data.collate", 0.0, 0.01)]
    t = 0.01
    for name in ("train.h2d", "train.forward", "train.ctc", "train.backward"):
        host.append((name, t, t + 0.02))
        t += 0.02
    host += [("train.optimizer", t, t + 0.03), ("train.clip", t + 0.005, t + 0.01),
             ("aten::_foreach_norm", t + 0.006, t + 0.007)]
    tr = trace.Trace("train", model, calls, 0.5, [("k", 0.0, 0.1)], host)
    assert math.isclose(run.reader("dispatch_ms.train").read(tr), 110.0)
    assert math.isclose(run.reader("collate_ms.train").read(tr), 10.0)
    assert math.isclose(spans.per_call_ms(tr, "train", ["train.clip"]), 5.0)


def test_a_reader_reads_nothing_without_its_spans():
    full = program_spans()
    tr = offline_trace(full)
    for name in list(OFFLINE) + list(TRAIN):   # the wrong kind, or no such spans
        assert run.reader(name).read(trace.Trace("train" if name in OFFLINE else "offline",
                                                 tr.model, tr.calls, 2.0, tr.device,
                                                 full)) is None
    parent = offline_trace([("portbench.call", 0.0, 1.0), ("portbench.call", 1.0, 2.0),
                            ("aten::mm", 0.1, 0.2)])
    for name in OFFLINE:                        # a program without the spans
        assert run.reader(name).read(parent) is None
    no_wire = offline_trace([s for s in full if s[0] != "transcribe.wire"])
    assert run.reader("host_prep_ms.offline").read(no_wire) is None    # one name missing
    assert math.isclose(run.reader("h2d_ms.offline").read(no_wire), 20.0)
    one_call = offline_trace(program_spans(n_calls=1, buckets=1), n_calls=2)
    for name in OFFLINE:                        # fewer spans than calls
        assert run.reader(name).read(one_call) is None
    no_calls = trace.Trace("offline", tr.model, [], 2.0, tr.device, full)
    assert all(run.reader(name).read(no_calls) is None for name in OFFLINE)


def test_the_spans_change_no_existing_reader():
    bare = [("portbench.call", 0.0, 1.0), ("portbench.call", 1.0, 2.0), ("aten::mm", 0.1, 0.2)]
    without, with_spans = offline_trace(bare), offline_trace(bare + program_spans())
    for tr in (without, with_spans):
        tr.host_system_s, tr.host_wall_s = 0.25, 2.0
    readers = existing_readers()
    assert "scan_roofline.offline" in readers and "mfu.train" in readers
    for name in readers:
        assert run.reader(name).read(without) == run.reader(name).read(with_spans), name
    # idle seconds inside the stages now carry the program's names
    before, after = without.gap_labels(), with_spans.gap_labels()
    assert after["portbench.call"] < before["portbench.call"]
    assert any(name.startswith("transcribe.") for name in after)


@pytest.fixture(scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(mel_bins=80, d_model=16, ssm_layers=2, ssm_state_dim=4, ssm_expand_ratio=2,
            ssm_kernel_size=4, global_ssm_layers=1, global_ssm_state_dim=4, attention_heads=2,
            attention_dim=8, vocab_size=30, dropout=0.1, scan_mode="parallel", dtype="float32")


def profiled(kind, calls, body, tmp_path):
    """The harness's Trace of `body`'s calls, each in a ``portbench.call``,
    profiled on the CPU and reduced as a traced run reduces its slice."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function(trace.SLICE):
            for _ in calls:
                with torch.profiler.record_function(trace.CALL):
                    body()
    path = str(tmp_path / f"{kind}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return trace.reduce_events(events, kind, TINY, calls)


def test_the_readers_read_the_programs_spans_from_a_profile(tmp_path, one_torch_thread):
    from velocity_asr_tpu_torch.data import ASRCollator
    from velocity_asr_tpu_torch.decode import CTCDecoder, create_default_vocabulary
    from velocity_asr_tpu_torch.models.config import VelocityASRConfig
    from velocity_asr_tpu_torch.models.model import create_model
    from velocity_asr_tpu_torch.training import Trainer, TrainingConfig
    from velocity_asr_tpu_torch.transcribe import Transcriber

    rng = np.random.default_rng(2)
    audio = [(0.3 * rng.standard_normal(n)).astype(np.float32) for n in (9000, 20000)]
    gen = torch.Generator().manual_seed(0)
    moe = create_model(VelocityASRConfig(**TINY, moe_experts=4, moe_top_k=2), device="cpu",
                       generator=gen)
    transcriber = Transcriber(moe, CTCDecoder(create_default_vocabulary(30)), frame_bucket=100)
    calls = [{"frames": 200, "rows": [9000, 20000]}] * 2
    tr = profiled("offline", calls, lambda: transcriber.transcribe_batch(audio), tmp_path)
    for name in OFFLINE:
        assert run.reader(name).read(tr) > 0, name

    model = create_model(VelocityASRConfig(**TINY), device="cpu", generator=gen)
    trainer = Trainer(model, TrainingConfig(max_steps=10, warmup_steps=1, batch_size=2),
                      iter(()), seed=0)
    collate = ASRCollator(frame_bucket=100)
    items = [{"audio": a, "targets": np.arange(3, 9, dtype=np.int32),
              "input_lengths": np.int32(1 + len(a) // 160), "target_lengths": np.int32(6)}
             for a in audio]
    tr = profiled("train", calls[:1], lambda: trainer.train_step(collate(items)), tmp_path)
    for name in TRAIN:
        assert run.reader(name).read(tr) > 0, name
