"""Time checkouts of this repository against each other on one card, in turns.

    python3 velocity_asr_tpu_torch/compare_trees.py OLD NEW [--order ABBAAB] [--steps 200]

OLD and NEW are roots of two checkouts (a parent commit unpacked with
``git archive`` and this tree, say). Each turn is a fresh process that
imports the ``velocity_asr_tpu_torch`` package of one tree, so its
kernels are built from that tree's own sources, and measures, through
the package's public wrappers:

- the scan forward's four entries (``ops.scan.scan_fwd``,
  ``scan_fwd_state``, ``scan_fwd_bounds``, ``scan_fwd_bounds_state``) at
  the shapes the paths run most (offline batch 1 at (200, N=64) and (64,
  N=32), batched at (16, 300); streaming at (1, 100) and (16, 100);
  training at (16, 300) and, with a state, (8, 100); D = 384): device time
  per call from a CUDA graph of many calls, and the host's time to issue
  one eager call;
- the scan backward (``ops.scan.scan_bwd``, ``scan_bwd_state``) at the
  training paths' shapes: device time per call from a CUDA graph of many
  calls, and the host's time to issue one eager call;
- both int8 dense kernels (``ops.int8_matmul.int8_dot``, dynamic and
  static scale) at the batched int8 path's main shapes (16 x 300 rows:
  192 -> 192, the gate's 384 -> 192, the CTC head's 192 -> 30) and one
  pooled shape of 256 rows, x in fp32 and in bf16 (a tree whose wrapper
  converts bf16 x to fp32 pays that conversion inside the time): device
  time per call from a CUDA graph of many calls;
- the training CLI's micro-step (``train.main`` on configs/train_synth.yaml
  and model_synth.yaml, ``--synthetic 3200``, bf16; the offline training
  path of chip_smoke.py's phase 8b): ms per micro-step to a synchronise,
  and the host's time per backward call inside those micro-steps.

The order's letters name the trees in the order given (A = OLD, B = NEW);
``ABBAAB`` runs OLD, NEW, NEW, OLD, OLD, NEW, so that drift over the call
falls on both. The turns' outputs at each shape are held against each
other: the forward's states (bounds, h_final) bit for bit and its y
element by element within 1e-4 of max|y| (each turn saves them in a
temporary directory), the sums of |.| of every gradient and int8 output
within 1e-4 relative. Prints the card's name and power limit, one line
per measurement, each tree's median and spread per forward and int8
shape, and last a JSON object with every turn. ``--device cpu`` runs small shapes with the
plain versions and no micro-steps: it checks the tool, and times nothing
of the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

CARD_SHAPES = ((16, 300, 384, 64, False), (8, 100, 384, 64, True), (8, 1200, 384, 64, False))
CPU_SHAPES = ((2, 37, 16, 8, False), (2, 20, 16, 8, True))
# (M, K, N) of the int8 turns, and the types of x
INT8_CARD_SHAPES = ((4800, 192, 192), (4800, 384, 192), (4800, 192, 30), (256, 192, 192))
INT8_CPU_SHAPES = ((37, 50, 30), (64, 192, 48))
INT8_TYPES = ("float32", "bfloat16")
AGREE_MAX_REL = 1e-4
# (entry, batch, length, state_dim) of the forward turns, d_inner 384 on
# the card (PERF.md's rows 1, 3, 4 and 4s) and 16 on the CPU
FWD_CARD_SHAPES = (("scan_fwd_f32", 1, 200, 64), ("scan_fwd_f32", 1, 64, 32),
                   ("scan_fwd_f32", 16, 300, 64), ("scan_fwd_state_f32", 1, 100, 64),
                   ("scan_fwd_state_f32", 16, 100, 64), ("scan_fwd_bounds_f32", 16, 300, 64),
                   ("scan_fwd_bounds_state_f32", 8, 100, 64))
FWD_CPU_SHAPES = (("scan_fwd_f32", 2, 37, 8), ("scan_fwd_state_f32", 2, 20, 8),
                  ("scan_fwd_bounds_f32", 2, 37, 8), ("scan_fwd_bounds_state_f32", 2, 20, 8))
FWD_GRAPH_CALLS = 50
EAGER_CALLS = 50
GRAPH_CALLS = 10
INT8_GRAPH_CALLS = 100
WARMUP_STEPS = 10  # micro-steps left out of the per-step figures

_CHILD = ("import importlib.util, sys; "
          "spec = importlib.util.spec_from_file_location('compare_trees_turn', sys.argv[1]); "
          "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod); "
          "mod.turn(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5])")


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


def _cpu_ms(call, calls=3):
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    return (time.perf_counter() - t0) / calls * 1e3


def _graph_ms(call, calls):
    """Device ms per call: `calls` calls captured in a CUDA graph, one
    replay timed between two events after a warm replay."""
    import torch

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _time_int8(shape, dtype, device):
    """Device ms per call (CUDA graph) of the dynamic and the static int8
    kernel through ``int8_dot``, and the sums of |.| of their outputs, at
    one (M, K, N) with x in `dtype`, from a fixed seed."""
    import numpy as np
    import torch

    from velocity_asr_tpu_torch.ops import int8_matmul

    m, k, n = shape
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, k)) * rng.uniform(0.25, 4.0, (m, 1))
    w = rng.standard_normal((n, k)) * 0.1
    x = torch.tensor(x.astype(np.float32), device=device).to(getattr(torch, dtype))
    w_q, w_scale = int8_matmul.quantize_weight(torch.tensor(w.astype(np.float32), device=device))
    x_scale = int8_matmul.scale_of(x.float().abs().amax() * 0.8)
    calls = {"dynamic": lambda: int8_matmul.int8_dot(x, w_q, w_scale),
             "static": lambda: int8_matmul.int8_dot(x, w_q, w_scale, x_scale)}
    out = {"shape": list(shape), "dtype": dtype,
           "sums": [float(call().double().abs().sum()) for call in calls.values()]}
    for name, call in calls.items():
        if device == "cpu":
            out[f"{name}_cpu_wall_ms"] = _cpu_ms(call)
        else:
            out[f"{name}_device_ms"] = _graph_ms(call, INT8_GRAPH_CALLS)
    return out


def _time_forward(index, entry, shape, device, out_dir):
    """Device ms per call (CUDA graph) and host ms to issue an eager call
    of one forward entry through its wrapper; its outputs (y, then the
    bounds and h_final it returns) saved as fwd{index}_{k}.npy in
    out_dir."""
    import numpy as np
    import torch

    from velocity_asr_tpu_torch.ops import scan

    x, dt, A, B, C, _, h0, _ = _inputs(shape + (False,), device)
    with_state = entry in ("scan_fwd_state_f32", "scan_fwd_bounds_state_f32")
    wrapper = {"scan_fwd_f32": scan.scan_fwd, "scan_fwd_state_f32": scan.scan_fwd_state,
               "scan_fwd_bounds_f32": scan.scan_fwd_bounds,
               "scan_fwd_bounds_state_f32": scan.scan_fwd_bounds_state}[entry]
    args = (x, dt, A, B, C, h0) if with_state else (x, dt, A, B, C)

    def call():
        return wrapper(*args)

    outs = call()
    outs = outs if isinstance(outs, tuple) else (outs,)
    for k, t in enumerate(outs):
        np.save(os.path.join(out_dir, f"fwd{index}_{k}.npy"), t.cpu().numpy())
    out = {"entry": entry, "shape": list(shape), "outputs": len(outs)}
    if device == "cpu":
        out["cpu_wall_ms"] = _cpu_ms(call)
        return out
    out["device_ms"] = _graph_ms(call, FWD_GRAPH_CALLS)
    t0 = time.perf_counter()
    for _ in range(EAGER_CALLS):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    out["host_issue_ms"] = (t1 - t0) / EAGER_CALLS * 1e3
    return out


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
        out["cpu_wall_ms"] = _cpu_ms(call)
        return out
    out["device_ms"] = _graph_ms(call, GRAPH_CALLS)
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


def turn(tree, device, steps, out_dir):
    """One turn, in its own process: print one JSON line of measurements
    and save the forward's outputs in out_dir."""
    sys.path.insert(0, tree)
    from velocity_asr_tpu_torch.device import resolve_device

    resolve_device(device)
    shapes = CPU_SHAPES if device == "cpu" else CARD_SHAPES
    int8_shapes = INT8_CPU_SHAPES if device == "cpu" else INT8_CARD_SHAPES
    d_inner = 16 if device == "cpu" else 384
    forward = [_time_forward(i, entry, (batch, length, d_inner, state_dim), device, out_dir)
               for i, (entry, batch, length, state_dim) in enumerate(
                   FWD_CPU_SHAPES if device == "cpu" else FWD_CARD_SHAPES)]
    out = {"tree": tree, "forward": forward,
           "backward": [_time_backward(s, device) for s in shapes],
           "int8": [_time_int8(s, dtype, device) for s in int8_shapes for dtype in INT8_TYPES]}
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
    the others, shape by shape, over the backward and the int8 kernels."""
    worst = 0.0
    for t in turns[1:]:
        for part in ("backward", "int8"):
            for ref, got in zip(turns[0][part], t[part]):
                for a, b in zip(ref["sums"], got["sums"]):
                    worst = max(worst, abs(a - b) / max(abs(a), 1e-30))
    return worst


def _forward_agree(turns, dirs):
    """Per forward shape, against the first turn: whether every state
    output (bounds, h_final) of every turn is bit-equal, and the largest
    max|y - y_first| / max|y_first| of any turn."""
    import numpy as np

    out = []
    for i, first in enumerate(turns[0]["forward"]):
        same, worst = True, 0.0
        ref = [np.load(os.path.join(dirs[0], f"fwd{i}_{k}.npy")) for k in range(first["outputs"])]
        for d in dirs[1:]:
            got = [np.load(os.path.join(d, f"fwd{i}_{k}.npy")) for k in range(first["outputs"])]
            worst = max(worst, float(np.abs(got[0] - ref[0]).max() / np.abs(ref[0]).max()))
            same = same and all(a.tobytes() == b.tobytes() for a, b in zip(got[1:], ref[1:]))
        out.append({"entry": first["entry"], "shape": first["shape"], "states_bit_equal": same,
                    "y_max_rel": worst})
    return out


def _summary(turns, part, kernels):
    """Per shape of one part ("forward", "int8") and kernel (the time's key
    prefix): each tree's median device ms over its turns and the spread
    (max - min) of its turns."""
    import statistics

    lines = []
    for i, first in enumerate(turns[0][part]):
        for kernel in kernels:
            parts = []
            for letter in sorted({t["letter"] for t in turns}):
                ms = [t[part][i][f"{kernel}device_ms"] for t in turns if t["letter"] == letter]
                parts.append(f"{letter} median {statistics.median(ms):.4f} ms (spread "
                             f"{max(ms) - min(ms):.4f}, {len(ms)} turns)")
            name = first.get("entry", f"int8 {kernel.rstrip('_')}")
            extra = f" x {first['dtype']}" if "dtype" in first else ""
            lines.append(f"{name} {tuple(first['shape'])}{extra}: " + "; ".join(parts))
    return lines


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
    with tempfile.TemporaryDirectory(prefix="compare_trees_") as tmp:
        return _run_turns(args, letters, steps, here, tmp)


def _run_turns(args, letters, steps, here, tmp) -> int:
    turns, dirs = [], []
    for i, letter in enumerate(args.order):
        tree = letters[letter]
        dirs.append(os.path.join(tmp, f"turn{i}"))
        os.makedirs(dirs[-1])
        proc = subprocess.run([sys.executable, "-c", _CHILD, here, tree, args.device, str(steps),
                               dirs[-1]], cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            print(f"turn {letter} ({tree}) failed with exit code {proc.returncode}", flush=True)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["letter"] = letter
        turns.append(result)
        for f in result["forward"]:
            times = ", ".join(f"{k} {f[k]:.4f}" for k in ("device_ms", "host_issue_ms", "cpu_wall_ms")
                              if k in f)
            print(f"turn {letter} {f['entry']} {tuple(f['shape'])}: {times}", flush=True)
        for b in result["backward"]:
            times = ", ".join(f"{k} {b[k]:.4f}" for k in ("device_ms", "host_issue_ms", "cpu_wall_ms")
                              if k in b)
            print(f"turn {letter} scan backward {tuple(b['shape'])}: {times}", flush=True)
        for r in result["int8"]:
            times = ", ".join(f"{k} {r[k]:.4f}" for k in (
                "dynamic_device_ms", "static_device_ms", "dynamic_cpu_wall_ms",
                "static_cpu_wall_ms") if k in r)
            print(f"turn {letter} int8 {tuple(r['shape'])} x {r['dtype']}: {times}", flush=True)
        if "train" in result:
            print(f"turn {letter} train: {json.dumps(result['train'])}", flush=True)
    if args.device == "cuda":
        for line in (_summary(turns, "forward", ("",))
                     + _summary(turns, "int8", ("dynamic_", "static_"))):
            print(line, flush=True)
    forward = _forward_agree(turns, dirs)
    fwd_ok = True
    for f in forward:
        good = f["states_bit_equal"] and f["y_max_rel"] <= AGREE_MAX_REL
        fwd_ok = fwd_ok and good
        print(f"forward across turns {f['entry']} {tuple(f['shape'])}: states (bounds, h_final) "
              f"{'bit-equal' if f['states_bit_equal'] else 'DIFFER'}; y max_rel "
              f"{f['y_max_rel']:.3e} (tol {AGREE_MAX_REL:g}) {'ok' if good else 'FAIL'}", flush=True)
    worst = _agree(turns)
    ok = worst <= AGREE_MAX_REL and fwd_ok
    print(f"outputs across turns: max relative gap of the gradients' and int8 outputs' sums "
          f"{worst:.3e} ({'within' if worst <= AGREE_MAX_REL else 'above'} {AGREE_MAX_REL:g})",
          flush=True)
    print(json.dumps({"ok": ok, "device": args.device, "forward": forward, "turns": turns}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
