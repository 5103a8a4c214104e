"""The log-mel kernel's share of its roofline: the least time the card
could take to read each call's int16 PCM once and write its mel once
(``counts.log_mel_seconds``), over the slice's ``log_mel_f32`` launches'
summed device time. Nothing outside an offline slice or without a
launch a call."""

from portbench import counts

LAYER = "front end"
PATTERN = r"log_mel_kernel"


def read(trace):
    if trace.kind != "offline":
        return None
    launches = trace.kernels(PATTERN)
    if not launches or len(launches) < len(trace.calls):
        return None
    least = sum(counts.log_mel_seconds(len(c["rows"]), c["frames"]) for c in trace.calls)
    return 100.0 * least / sum(end - start for _, start, end in launches)
