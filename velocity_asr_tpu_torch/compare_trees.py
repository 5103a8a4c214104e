"""Time checkouts of this repository against each other on one card, in turns.

    python3 velocity_asr_tpu_torch/compare_trees.py OLD NEW [--order ABBAAB] [--steps 200]

OLD and NEW are roots of two checkouts (a parent commit unpacked with
``git archive`` and this tree, say). Each turn is a fresh process that
imports the ``velocity_asr_tpu_torch`` package of one tree, so its
kernels are built from that tree's own sources, and measures, through
the package's public wrappers:

- the scan backward (``ops.scan.scan_bwd``, ``scan_bwd_state``) at the
  training paths' shapes: device time per call from a CUDA graph of many
  calls, and the host's time to issue one eager call;
- the training CLI's micro-step (``train.main`` on configs/train_synth.yaml
  and model_synth.yaml, ``--synthetic 3200``, bf16; the offline training
  path of chip_smoke.py's phase 8b): ms per micro-step to a synchronise,
  and the host's time per backward call inside those micro-steps.

The order's letters name the trees in the order given (A = OLD, B = NEW);
``ABBAAB`` runs OLD, NEW, NEW, OLD, OLD, NEW, so that drift over the call
falls on both. The turns' outputs at each shape are held against each
other (sums of |.| of every gradient, within 1e-4 relative). Prints the
card's name and power limit, one line per measurement, and last a JSON
object with every turn. ``--device cpu`` runs small shapes with the plain
versions and no micro-steps: it checks the tool, and times nothing of
the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CARD_SHAPES = ((16, 300, 384, 64, False), (8, 100, 384, 64, True), (8, 1200, 384, 64, False))
CPU_SHAPES = ((2, 37, 16, 8, False), (2, 20, 16, 8, True))
AGREE_MAX_REL = 1e-4
EAGER_CALLS = 50
GRAPH_CALLS = 10
WARMUP_STEPS = 10  # micro-steps left out of the per-step figures

_CHILD = ("import importlib.util, sys; "
          "spec = importlib.util.spec_from_file_location('compare_trees_turn', sys.argv[1]); "
          "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod); "
          "mod.turn(sys.argv[2], sys.argv[3], int(sys.argv[4]))")


def _inputs(shape, device):
    """x, dt, A, B, C, g, h0, gh of one shape from a fixed seed."""
    import numpy as np
    import torch

    batch, length, d_inner, state_dim, _ = shape
    rng = np.random.default_rng(11)
    arrays = [
        rng.standard_normal((batch, length, d_inner)),
        np.log1p(np.exp(rng.standard_normal((batch, length, d_inner)) - 1.0)),
        -np.arange(1, state_dim + 1),
        rng.standard_normal((batch, length, state_dim)),
        rng.standard_normal((batch, length, state_dim)),
        rng.standard_normal((batch, length, d_inner)),
        rng.standard_normal((batch, d_inner, state_dim)),
        rng.standard_normal((batch, d_inner, state_dim)),
    ]
    return [torch.tensor(a.astype(np.float32), device=device) for a in arrays]


def _time_backward(shape, device):
    """Device ms per call (CUDA graph), host ms to issue an eager call, and
    the sums of |.| of the outputs, for one shape."""
    import torch

    from velocity_asr_tpu_torch.ops import scan

    x, dt, A, B, C, g, h0, gh = _inputs(shape, device)
    with_state = shape[4]
    if with_state:
        _, bounds, _ = scan.scan_fwd_bounds_state(x, dt, A, B, C, h0)
    else:
        _, bounds = scan.scan_fwd_bounds(x, dt, A, B, C)

    def call():
        if with_state:
            return scan.scan_bwd_state(x, dt, A, B, C, bounds, g, gh)
        return scan.scan_bwd(x, dt, A, B, C, bounds, g)

    sums = [float(t.double().abs().sum()) for t in call()]
    out = {"shape": list(shape), "sums": sums}
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        out["cpu_wall_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        return out
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    out["device_ms"] = start.elapsed_time(end) / GRAPH_CALLS
    del graph
    t0 = time.perf_counter()
    for _ in range(EAGER_CALLS):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    out["host_issue_ms"] = (t1 - t0) / EAGER_CALLS * 1e3
    return out


def _time_steps(tree, steps):
    """The training CLI's micro-steps on the card: ms per micro-step to a
    synchronise, and the host's ms per scan_bwd call inside them."""
    import tempfile

    import numpy as np
    import torch

    from velocity_asr_tpu_torch import train as cli
    from velocity_asr_tpu_torch import training
    from velocity_asr_tpu_torch.ops import scan

    step_ms, bwd_ms = [], []
    step, bwd = training.Trainer._step, scan.scan_bwd

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(self, batch)
        loss.item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return loss

    def timed_bwd(*args):
        t0 = time.perf_counter()
        out = bwd(*args)
        bwd_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    training.Trainer._step, scan.scan_bwd = timed_step, timed_bwd
    try:
        with tempfile.TemporaryDirectory(prefix="compare_trees_") as tmp:
            cli.main(["--config", os.path.join(tree, "configs", "train_synth.yaml"),
                      "--model-config", os.path.join(tree, "configs", "model_synth.yaml"),
                      "--synthetic", "3200", "--max-steps", str(steps),
                      "--checkpoint-dir", tmp, "--device", "cuda"])
    finally:
        training.Trainer._step, scan.scan_bwd = step, bwd
    kept = step_ms[WARMUP_STEPS:]
    per_step = len(bwd_ms) // max(len(step_ms), 1)
    kept_bwd = bwd_ms[WARMUP_STEPS * per_step:]
    return {"steps": len(step_ms), "step_p50_ms": float(np.percentile(kept, 50)),
            "step_p95_ms": float(np.percentile(kept, 95)),
            "bwd_calls": len(bwd_ms), "bwd_host_mean_ms": float(np.mean(kept_bwd))}


def turn(tree, device, steps):
    """One turn, in its own process: print one JSON line of measurements."""
    sys.path.insert(0, tree)
    from velocity_asr_tpu_torch.device import resolve_device

    resolve_device(device)
    shapes = CPU_SHAPES if device == "cpu" else CARD_SHAPES
    out = {"tree": tree, "backward": [_time_backward(s, device) for s in shapes]}
    if steps:
        out["train"] = _time_steps(tree, steps)
    print(json.dumps(out), flush=True)


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"


def _agree(turns):
    """Largest relative gap of any output sum between the first turn and
    the others, shape by shape."""
    worst = 0.0
    for t in turns[1:]:
        for ref, got in zip(turns[0]["backward"], t["backward"]):
            for a, b in zip(ref["sums"], got["sums"]):
                worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkout roots, named A, B, ... in this order")
    parser.add_argument("--order", default="ABBA", help="the turns, one letter each")
    parser.add_argument("--steps", type=int, default=200,
                        help="training micro-steps per turn on the card")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    letters = {chr(ord("A") + i): t for i, t in enumerate(trees)}
    if not args.order or any(c not in letters for c in args.order):
        parser.error(f"--order {args.order!r} names trees beyond {''.join(letters)}")
    steps = args.steps if args.device == "cuda" else 0
    if args.device == "cuda":
        print(_card(), flush=True)
    here = os.path.abspath(__file__)
    turns = []
    for letter in args.order:
        tree = letters[letter]
        proc = subprocess.run([sys.executable, "-c", _CHILD, here, tree, args.device, str(steps)],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            print(f"turn {letter} ({tree}) failed with exit code {proc.returncode}", flush=True)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["letter"] = letter
        turns.append(result)
        for b in result["backward"]:
            times = ", ".join(f"{k} {b[k]:.4f}" for k in ("device_ms", "host_issue_ms", "cpu_wall_ms")
                              if k in b)
            print(f"turn {letter} scan backward {tuple(b['shape'])}: {times}", flush=True)
        if "train" in result:
            print(f"turn {letter} train: {json.dumps(result['train'])}", flush=True)
    worst = _agree(turns)
    ok = worst <= AGREE_MAX_REL
    print(f"outputs across turns: max relative gap of the gradients' sums {worst:.3e} "
          f"({'within' if ok else 'above'} {AGREE_MAX_REL:g})", flush=True)
    print(json.dumps({"ok": ok, "device": args.device, "turns": turns}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
