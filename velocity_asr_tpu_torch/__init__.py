"""VELOCITY-ASR in PyTorch for NVIDIA Hopper: a port of velocity_asr_tpu.

It runs offline transcription: WAV -> log-mel (CUDA kernel) -> model
(selective-scan CUDA kernel in every SSM block) -> greedy CTC; and
batched evaluation over a manifest (``evaluate.py``), optionally with
int8 projections (int8 dense CUDA kernels, ``quantize.py``); and greedy
chunked streaming (``streaming.py``: a live ``StreamingTranscriber`` and
the batched ``BatchedStreamingTranscriber``), whose SSM blocks run the
carried-state scan kernel every chunk; and training of the offline CTC
objective (``train.py``, ``training.Trainer``), whose SSM blocks run the
bounds-saving scan forward and the scan backward kernels. Beam search
(``beam.py``, ``decode.CTCDecoder.decode_beam_search``) runs offline and
streaming on the logits' device, rescored by a character n-gram LM
(``lm.py``, built by ``train_lm.py``) and hot-word boosting
(``hotwords.py``).
Nothing here imports JAX or the JAX package.
"""

from .audio import compute_mel_spectrogram_np, load_audio, masked_normalize_mel
from .decode import CTCDecoder, create_default_vocabulary
from .models import VelocityASR, VelocityASRConfig, create_model, forward, from_pretrained
from .ops.mel import compute_mel_spectrogram

__all__ = [
    "CTCDecoder", "VelocityASR", "VelocityASRConfig", "compute_mel_spectrogram",
    "compute_mel_spectrogram_np", "create_default_vocabulary", "create_model",
    "forward", "from_pretrained", "load_audio", "masked_normalize_mel",
]
