"""Host milliseconds a step in the port's PCM collation (``data.collate``:
padding, int16 wire and targets), over the profiled slice's steps."""

from portbench import spans

LAYER = "entry (host dispatch)"
KIND = "train"
SPANS = ("data.collate",)


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
