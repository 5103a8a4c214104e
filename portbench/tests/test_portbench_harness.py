"""The harness: every cell resolves by name, the contract's shape holds,
the readers read a trace, the measurement path refuses to run without a
card, and a run with its timed path broken comes out not correct."""

import json
import math
import os
import re

import pytest
import torch

from portbench import counts, run, trace

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_workload_resolves_by_name():
    b = bench()
    for w in b["workloads"]:
        spec = run.cell(w["name"], b)
        assert spec["config"]["vocab_size"] > 0
        assert spec["mix"]["entry"]
        __import__(f"portbench.entries.{spec['mix']['entry']}")
        assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        for m in spec["per_layer"]:
            r = run.reader(m["name"])
            assert r.LAYER == m["layer"]


def test_benchmark_json_keeps_the_contracts_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))
    assert 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_measurement_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "base.offline", "--seed", "1", "--seconds", "1"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA" in captured.err


def test_readers_read_a_trace():
    model = run.cell("base.offline")["config"]
    calls = [{"frames": 400, "rows": [30000] * 4}]
    shapes = counts.scan_shapes(model, 4, 400)
    dev = [("void scan_fwd_kernel<1, 16, false, false, false>(Params)", 0.01 * i,
            0.01 * i + 0.005) for i in range(len(shapes))]
    dev.append(("log_mel_kernel(float const*)", 0.2, 0.21))
    tr = trace.Trace("offline", model, calls, 1.0, dev,
                     [("portbench.call", 0.0, 1.0), ("aten::mm", 0.1, 0.3)])
    least = sum(counts.scan_fwd_seconds(*s) for s in shapes)
    assert math.isclose(run.reader("scan_roofline.offline").read(tr),
                        100 * least / (0.005 * len(shapes)))
    assert math.isclose(run.reader("idle_share.offline").read(tr),
                        100 * (1 - (0.005 * len(shapes) + 0.01)))
    assert run.reader("device_ops_per_call.offline").read(tr) == len(shapes) + 1
    assert 0 < run.reader("mfu.offline").read(tr) < 100
    assert 0 < run.reader("log_mel_roofline.offline").read(tr) < 100
    assert run.reader("scan_roofline.train").read(tr) is None
    assert run.reader("host_system_share.offline").read(tr) is None     # not taken
    tr.host_system_s, tr.host_wall_s = 0.25, 2.0
    assert math.isclose(run.reader("host_system_share.offline").read(tr), 12.5)
    assert run.reader("host_system_share.train").read(tr) is None
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0][0] == "portbench.call" and dict(gaps)["aten::mm"] > 0
    empty = trace.Trace("offline", model, calls, 1.0, [("other", 0.0, 0.1)])
    assert run.reader("scan_roofline.offline").read(empty) is None
    assert run.reader("log_mel_roofline.offline").read(empty) is None
