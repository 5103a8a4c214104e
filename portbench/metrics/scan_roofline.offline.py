"""The inference scan's share of its roofline, over the slice's
``scan_fwd_f32`` launches: the least time the card could take for every
scan the slice's forwards run (``counts.scan_shapes``), over those
launches' summed device time. Nothing where a training slice is read,
no launch matches, or fewer launches match than the forwards run."""

from portbench import counts

LAYER = "scan kernels"
PATTERN = r"scan_fwd_kernel<\d+, ?\d+, ?false, ?false, ?false>"


def read(trace):
    if trace.kind != "offline":
        return None
    launches = trace.kernels(PATTERN)
    shapes = [s for c in trace.calls for s in counts.scan_shapes(trace.model, len(c["rows"]),
                                                                   c["frames"])]
    if not launches or len(launches) < len(shapes):
        return None
    least = sum(counts.scan_fwd_seconds(*s) for s in shapes)
    return 100.0 * least / sum(end - start for _, start, end in launches)
