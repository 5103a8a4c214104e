"""Host milliseconds a ``train_step`` call spends inside its stages: the
batch's copy to the card, the forward, the loss, the backward, the clip
and the optimizer (the ``train.h2d``, ``train.forward``, ``train.ctc``,
``train.backward``, ``train.clip`` and ``train.optimizer`` spans), over
the profiled slice's steps."""

from portbench import spans

LAYER = "whole step"
KIND = "train"
SPANS = ("train.h2d", "train.forward", "train.ctc", "train.backward", "train.clip",
         "train.optimizer")


def read(trace):
    return spans.per_call_ms(trace, KIND, SPANS)
