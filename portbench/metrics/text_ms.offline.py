"""Host milliseconds a call that the offline entry spends turning the
decoded tokens into text (``transcribe.text``), over the profiled
slice's calls."""

from portbench import spans

LAYER = "decode"
KIND = "offline"
SPANS = ("transcribe.text",)


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
