"""The share of the profiled slice's wall time that the union of every
device kernel, copy and set interval leaves uncovered, taken inside that
same window (offline slices)."""

LAYER = "device"
KIND = "offline"


def read(trace):
    return trace.idle_share() if trace.kind == KIND else None
