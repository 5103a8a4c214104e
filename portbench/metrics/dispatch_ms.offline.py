"""Host milliseconds a call that the offline entry spends enqueueing the
log-mel, the model and the greedy decode (``transcribe.forward``; the MoE
layer's spans lie inside it), over the profiled slice's calls."""

from portbench import spans

LAYER = "model"
KIND = "offline"
SPANS = ("transcribe.forward",)


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
