"""Host milliseconds a call that the offline entry spends padding each
frame bucket's rows and joining them (``transcribe.pad``) and turning them
into int16 PCM (``transcribe.wire``), over the profiled slice's calls."""

from portbench import spans

LAYER = "entry (host dispatch)"
KIND = "offline"
SPANS = ("transcribe.pad", "transcribe.wire")


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
