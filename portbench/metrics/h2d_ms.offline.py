"""Host milliseconds a call that the offline entry spends putting the int16
PCM and the valid frame counts on the card (``transcribe.h2d``: a pageable
copy, so the host stages it), over the profiled slice's calls."""

from portbench import spans

LAYER = "entry (host dispatch)"
KIND = "offline"
SPANS = ("transcribe.h2d",)


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
