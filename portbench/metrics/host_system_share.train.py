"""The share of the profiled train slice's wall time the process spent
in the host's kernel (``Trace.host_system_share``): chiefly the faults
that map and zero the fresh pages of the program's per-call arrays."""

LAYER = "entry (host dispatch)"
KIND = "train"


def read(trace):
    return trace.host_system_share() if trace.kind == KIND else None
