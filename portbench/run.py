"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload base.offline --seed 7 --seconds 30 --trace 0

The cell comes from ``BENCHMARK.json``: its configuration
(``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<mix>.json``, whose ``entry`` names the module in
``portbench/entries/`` that drives the program), the limits its outputs
are held to (``portbench/limits/<workload>.json``) and, with ``--trace
1``, the readers of its per-layer metrics (``portbench/metrics/<metric>.py``).
Nothing is listed in code: each piece is found by its name. The run
measures the program as its users run it: in the environment it is
given, with the allocator and thread settings of a default process.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``[, ``breakdown``],
``checks``); every number compared is also printed beside its limit as
the last lines of standard error. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 2; if JAX or
the JAX package is loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the run's set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "velocity_asr_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str, bench: dict = None) -> dict:
    """Everything one cell names, found by name: {"workload", "chips",
    "config_name", "config", "mix_name", "mix", "limits", "end_to_end",
    "per_layer"} (the metrics this cell reports)."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    row = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if row is None:
        raise SystemExit(f"unknown workload {workload!r}")
    config = next(c for c in bench["configs"] if c["name"] == row["config"])

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in names]
    return {"workload": workload, "chips": row["chips"], "config_name": config["name"],
            "config": load_json(ROOT, config["file"]), "mix_name": row["traffic"],
            "mix": load_json(HERE, "traffic", f"{row['traffic']}.json"),
            "limits": load_json(HERE, "limits", f"{workload}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str):
    """The module ``portbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def measure(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            control=None) -> dict:
    """Drive the cell's entry once and return the result's fields
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``checks``,
    ``readings``, ``memory_peak_bytes``, with a trace ``busy_s``,
    ``window_s`` and ``breakdown``). ``control`` ("fp8") puts the
    reference with fp8 weight products in the program's place for the
    comparison (``portbench.control``)."""
    entry = importlib.import_module(f"portbench.entries.{spec['mix']['entry']}")
    out = entry.run(spec, seed=seed, seconds=seconds, trace=trace, device=device, t0=T0,
                    control=control)
    if trace:
        values = {}
        tr = out.pop("trace")
        for m in spec["per_layer"]:
            v = None if tr is None else reader(m["name"]).read(tr)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = values
        if tr is not None:
            out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
            out["breakdown"] = tr.breakdown()
    else:
        out.pop("trace", None)
        out["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                          for m in spec["end_to_end"] if m["name"] in out["e2e"]}
    out.pop("e2e", None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: needs {spec['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = measure(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": spec["chips"], "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": power_limit()}
    if args.trace and "busy_s" in out:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, check in out["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
