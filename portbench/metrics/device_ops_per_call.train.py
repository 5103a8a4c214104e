"""Device kernels, copies and sets per ``train_step`` call in the
profiled slice: the dispatch work the host does for each call."""

LAYER = "entry (host dispatch)"
KIND = "train"


def read(trace):
    return trace.ops_per_call() if trace.kind == KIND else None
