"""Readings that set a cell's limits: the program's and its control's
numbers over many seeds, in one process (set-up is paid per seed).

    python3 -m portbench.control --workload base.offline --seconds 4 \
        --seeds 11 12 13 [--fault half_batch] [--control-only | --program-only]

The control is the reference with fp8 weight products in the program's
place; ``--fault`` plants a fault in the program for every run of the
call (``half_batch``: the training loss over half of the batch). A run prints one line per seed and side, then one JSON
line with every reading; the lower reading of a limit is the program's largest,
the upper the control's smallest. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def _half_batch():
    """Half of the batch left out of the loss, the mean taken over the rest."""
    from velocity_asr_tpu_torch.training import Trainer

    Trainer._row_mean = lambda self, per_row: per_row[: max(1, per_row.shape[0] // 2)].mean()


FAULTS = {"half_batch": _half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS),
                    help="plant this fault in the program instead of running a control")
    side = ap.add_mutually_exclusive_group()
    side.add_argument("--control-only", action="store_true")
    side.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    spec = run.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        FAULTS[args.fault]()
    sides = [None] if args.program_only else ["fp8"] if args.control_only else [None, "fp8"]
    readings = {"program": {}, "control": {}}
    for seed in args.seeds:
        for control in sides:
            out = run.measure(spec, seed, args.seconds, False, control=control)
            values = out["readings"]
            name = "control" if control else "program"
            readings[name][seed] = values
            print(f"{name} seed {seed}: {values}", flush=True)
    for name, by_seed in readings.items():
        for key in sorted({k for v in by_seed.values() for k in v}):
            vals = [v[key] for v in by_seed.values()]
            print(f"{name} {key}: min {min(vals)!r} max {max(vals)!r}")
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
