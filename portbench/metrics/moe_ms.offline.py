"""Host milliseconds a call inside the MoE layers' routing, dispatch,
expert matmuls and combine (the ``moe.*`` spans of every layer), over the
profiled slice's calls; a model without experts reads nothing."""

from portbench import spans

LAYER = "model"
KIND = "offline"
SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
