"""The training scans' share of their roofline, over the slice's
``scan_fwd_bounds_f32`` and ``scan_bwd_f32`` launches: the least time the
card could take for the forward with saved states and the backward of
every scan the slice's steps run, over those launches' summed device
time. Nothing outside a training slice or where fewer launches match."""

from portbench import counts

LAYER = "scan kernels"
FWD = r"scan_fwd_kernel<\d+, ?\d+, ?false, ?true, ?false>"
BWD = r"scan_bwd_kernel<\d+, ?false>"


def read(trace):
    if trace.kind != "train":
        return None
    fwd, bwd = trace.kernels(FWD), trace.kernels(BWD)
    shapes = [s for c in trace.calls for s in counts.scan_shapes(trace.model, len(c["rows"]),
                                                                   c["frames"])]
    if not fwd or not bwd or len(fwd) < len(shapes) or len(bwd) < len(shapes):
        return None
    least = sum(counts.scan_fwd_bounds_seconds(*s) + counts.scan_bwd_seconds(*s)
                for s in shapes)
    return 100.0 * least / sum(end - start for _, start, end in fwd + bwd)
