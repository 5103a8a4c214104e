"""VELOCITY-ASR in PyTorch for NVIDIA Hopper: a port of velocity_asr_tpu.

It runs offline transcription: WAV -> log-mel (CUDA kernel) -> model
(selective-scan CUDA kernel in every SSM block) -> greedy CTC; and
batched evaluation over a manifest (``evaluate.py``), optionally with
int8 projections (int8 dense CUDA kernels, ``quantize.py``); and greedy
chunked streaming (``streaming.py``: a live ``StreamingTranscriber`` and
the batched ``BatchedStreamingTranscriber``), whose SSM blocks run the
carried-state scan kernel every chunk; and training of the offline CTC
objective (``train.py``, ``training.Trainer``), whose SSM blocks run the
bounds-saving scan forward and the scan backward kernels, also with
quantization-aware training (``quantize.prepare_model_for_qat``). Beam
search (``beam.py``, ``decode.CTCDecoder.decode_beam_search``) runs
offline and streaming on the logits' device, rescored by a character
n-gram LM (``lm.py``, built by ``train_lm.py``) and hot-word boosting
(``hotwords.py``). ``export.py`` and ``export_model.py`` write a
``torch.export`` program and the int8 weight package. ``diarize.py``
trains a speaker encoder and diarizes audio (its embeddings through the
scan kernel); ``pretrain.py`` pretrains the backbone by masked-spectrogram
prediction for the Stage-2 fine-tune; ``compat/torch_convert.py`` reads
reference PyTorch checkpoints.

The public names are the JAX package's: its ``__all__`` here, and its
lazily imported names (trainer, data, beam, streaming, LM, hot words,
diarization, pretraining)
through ``__getattr__``. Nothing here imports JAX or the JAX package.
"""

__version__ = "2.0.0"

from .audio import (HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE, MelSpectrogramTransform,
                    audio_to_frames, compute_mel_spectrogram_np, frames_to_audio, load_audio,
                    masked_normalize_mel, mel_filterbank, pad_or_trim)
from .decode import (BLANK_TOKEN, CTCDecoder, DecodingResult, create_default_vocabulary,
                     ctc_beam_search, ctc_greedy_decode, ctc_greedy_decode_with_timestamps)
from .models import (AdaptivePool, CTCOutputHead, GatedFusion, GlobalSSM,
                     HierarchicalGlobalContext, LocalSSMProcessor, MultiHeadAttention,
                     PositionalEncoding2D, SelectiveSSM, SSMBlock, TemporalBindingLayer,
                     VelocityASR, VelocityASRConfig, count_parameters, create_model, forward,
                     from_pretrained, get_output_length, init_params, save_pretrained)
from .ops.mel import compute_mel_spectrogram
from .ops.scan import (ScanMode, selective_scan, selective_scan_parallel,
                       selective_scan_sequential)
from .quantize import (FakeQuantize, QuantConv1d, QuantDense, QuantizationConfig,
                       calibrate_model, get_model_size_mb, init_quant_stats, mark_calibrated,
                       prepare_model_for_qat)

__all__ = [
    "__version__",
    # audio
    "SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "N_MELS",
    "MelSpectrogramTransform", "audio_to_frames", "compute_mel_spectrogram",
    "compute_mel_spectrogram_np", "frames_to_audio", "load_audio", "masked_normalize_mel",
    "mel_filterbank", "pad_or_trim",
    # models
    "AdaptivePool", "CTCOutputHead", "GatedFusion", "GlobalSSM",
    "HierarchicalGlobalContext", "LocalSSMProcessor", "MultiHeadAttention",
    "PositionalEncoding2D", "SelectiveSSM", "SSMBlock", "TemporalBindingLayer",
    "VelocityASR", "VelocityASRConfig", "count_parameters", "create_model",
    "forward", "from_pretrained", "get_output_length", "init_params",
    "save_pretrained",
    # ops
    "ScanMode", "selective_scan", "selective_scan_parallel",
    "selective_scan_sequential",
    # decode
    "BLANK_TOKEN", "CTCDecoder", "DecodingResult", "create_default_vocabulary",
    "ctc_beam_search", "ctc_greedy_decode", "ctc_greedy_decode_with_timestamps",
    # quantize
    "FakeQuantize", "QuantConv1d", "QuantDense", "QuantizationConfig",
    "calibrate_model", "get_model_size_mb", "init_quant_stats",
    "mark_calibrated", "prepare_model_for_qat",
]

# name -> submodule of the lazily imported names (the heavier modules)
_LAZY = {
    **dict.fromkeys(("Trainer", "TrainingConfig", "CTCLoss", "WarmupCosineScheduler",
                     "compute_wer", "compute_cer"), "training"),
    **dict.fromkeys(("ASRDataset", "ASRCollator", "LibriSpeechDataset", "create_dataloader",
                     "create_librispeech_dataloaders"), "data"),
    **dict.fromkeys(("ctc_beam_search_torch", "beams_to_token_lists", "StreamingBeam",
                     "ctc_beam_resume", "beam_state_init", "beam_commit", "beam_finalize"),
                    "beam"),
    **dict.fromkeys(("StreamingTranscriber", "StreamingMel", "BatchedStreamingTranscriber",
                     "StreamSessionBatcher"), "streaming"),
    "HotwordBooster": "hotwords",
    **dict.fromkeys(("CharNGramLM", "CombinedScorer"), "lm"),
    **dict.fromkeys(("Diarizer", "DiarizeConfig", "SpeakerEncoder", "SpeakerEncoderConfig",
                     "SpeakerTrainer", "diarization_error_rate"), "diarize"),
    **dict.fromkeys(("MaskedPredictor", "MaskedPredictionConfig", "PretrainTrainer",
                     "init_asr_from_backbone"), "pretrain"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
