"""The whole step's share of the card's bf16 peak over the profiled
train slice (``counts.step_mfu``: the model FLOPs of the valid frames
its calls processed, over its wall seconds times 989 TFLOP/s)."""

from portbench import counts

LAYER = "whole step"
KIND = "train"


def read(trace):
    return counts.step_mfu(trace) if trace.kind == KIND and trace.calls else None
