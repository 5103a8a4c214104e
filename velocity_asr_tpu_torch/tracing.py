"""Named host spans for a ``torch.profiler`` trace.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler window records (the trainer's ``--profile-dir`` window, or any
``torch.profiler.profile`` the caller opens), so the spans sit on the
profiler's clock beside the device's kernels; otherwise it is one shared
null context, and the only cost is the check of the profiler's flag.

The spans of one call nest and never overlap. Names are ``<layer>.<stage>``
and do not change from call to call:

=====================  ===================================================
span                   covers
=====================  ===================================================
``transcribe.pad``     ``Transcriber.transcribe_batch``, once a frame
                       bucket: the kept staging buffer sized for the
                       bucket and the wait for the last bucket's copies
                       out of it (the first bucket's also the grouping
                       by bucket)
``transcribe.wire``    each row written into the buffer: scale, clip and
                       cast to int16 PCM, then the reflect pad in int16
``transcribe.h2d``     the enqueue of the PCM's and the valid frame
                       counts' copies to the device (asynchronous from
                       pinned memory on a CUDA device)
``transcribe.forward`` the host's enqueue of the log-mel, the model and
                       the greedy decode
``transcribe.fetch``   the decoded tokens back to the host (the host waits
                       on the device here)
``transcribe.text``    tokens to text
``data.collate``       ``ASRCollator.__call__``
``train.h2d``          ``Trainer._to_device``
``train.forward``      the loss up to the logits: waveform augmentation,
                       log-mel, SpecAugment and the model (the
                       streaming-aware term's forward again, where it runs)
``train.ctc``          the CTC term with the MoE aux and language-ID terms
                       added to it (the streaming term's again)
``train.backward``     ``torch.autograd.grad`` and the gradients' all-reduce
                       (the backward itself runs on autograd's device
                       thread: here the calling thread waits for it)
``train.optimizer``    ``Optimizer.step``
``train.clip``         inside ``train.optimizer``: the global norm and the
                       two clipping launches
``train.fetch``        the loss back to the host in ``Trainer.train_step``
``moe.route``          ``MoEFFN.route``, once a layer a forward
``moe.dispatch``       the slot table and the gather of the experts' inputs
``moe.experts``        both expert matmuls, the GELU and the dropout
``moe.combine``        the gather of the outputs and their weighted sum
=====================  ===================================================
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a profiler records, else the
    shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL
