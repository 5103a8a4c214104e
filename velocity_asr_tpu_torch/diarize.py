"""Speaker diarization (mirrors velocity_asr_tpu/diarize.py and its CLI,
scripts/diarize.py): who spoke when, with speaker-attributed ASR.

- ``SpeakerEncoder``: the ASR encoder's front end (``TemporalBindingLayer``
  and the ``LocalSSMProcessor`` stack, whose scans run the selective-scan
  kernel on the card) followed by masked mean + std pooling in fp32, an
  fp32 ``emb_proj`` and L2 normalisation. ``SpeakerClassifier`` adds the
  cosine classifier (``class_weights``) that ``SpeakerTrainer`` trains
  with the additive-margin softmax (``am_softmax_loss``) on the port's
  ``Trainer`` runtime; the speaker id rides in ``targets[:, 0]``
  (``synth.SyntheticSpeakerDataset``).
- Artifacts: the ``save_pretrained`` layout tagged ``objective:
  speaker_embedding`` (``config.json`` + flax ``params.msgpack``), which
  both packages read; inference uses the ``encoder`` subtree.
- ``Diarizer``: host mel (un-normalised) -> energy VAD -> sliding windows
  over the speech -> embeddings on the device, ``batch_bucket`` windows a
  call -> clustering on the host (spectral with a silhouette-chosen count,
  or agglomerative) -> nearest-centroid refinement -> frame-vote segments.
- ``diarization_error_rate``: DER (miss + false alarm + confusion over the
  reference speech) with the optimal speaker mapping and a collar.

    python -m velocity_asr_tpu_torch.diarize train --checkpoint-dir DIR [--device cuda]
    python -m velocity_asr_tpu_torch.diarize eval --speaker-model DIR/final_speaker \\
        [--known-speakers] [--out der.json]
    python -m velocity_asr_tpu_torch.diarize files --speaker-model DIR \\
        [--asr-model CKPT] a.wav b.flac

The host parts (VAD, windows, clustering, DER) are numpy and scipy copies
of the JAX package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .audio import HOP_LENGTH, SAMPLE_RATE, compute_mel_spectrogram_np
from .checkpoint import params_from_numpy, read_params
from .device import resolve_device
from .models.layers import Dense, TemporalBindingLayer
from .models.ssm import LocalSSMProcessor
from .training import Trainer

logger = logging.getLogger(__name__)

#: seconds per mel frame (10 ms hop)
FRAME_S = HOP_LENGTH / SAMPLE_RATE

SPEAKER_OBJECTIVE = "speaker_embedding"


# ----- model ------------------------------------------------------------------


@dataclass
class SpeakerEncoderConfig:
    """The speaker-embedding model: the ASR encoder's modules at a smaller
    scale, the embedding width, and the classifier head's speakers,
    margin and scale (training only)."""

    mel_bins: int = 80
    d_model: int = 128
    ssm_layers: int = 4
    ssm_state_dim: int = 32
    ssm_expand_ratio: int = 2
    ssm_kernel_size: int = 4
    dropout: float = 0.1
    embedding_dim: int = 128
    n_speakers: int = 64
    am_margin: float = 0.2
    am_scale: float = 30.0
    scan_mode: str = "parallel"
    dtype: str = "float32"
    qat: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpeakerEncoderConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def scalar_normalize_mel(mel: np.ndarray) -> np.ndarray:
    """Loudness-only normalisation for the speaker path: one mean and one
    population std (ddof 0) over every (frame, bin) cell, so the cross-bin
    energy profile (the voice's formants) survives, where the ASR
    front end's per-bin normalisation would flatten it."""
    mean = mel.mean()
    std = mel.std() + 1e-5
    return ((mel - mean) / std).astype(np.float32)


def masked_stats_pool(feats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked mean and std over time: (B, T, D), (B, T) -> (B, 2D), in
    fp32 whatever the compute dtype; std = sqrt(var + 1e-8), the count
    floored at 1."""
    feats = feats.to(torch.float32)
    m = valid.to(torch.float32)[..., None]
    n = torch.clamp(m.sum(dim=1), min=1.0)
    mean = (feats * m).sum(dim=1) / n
    var = (((feats - mean[:, None, :]) ** 2) * m).sum(dim=1) / n
    return torch.cat([mean, torch.sqrt(var + 1e-8)], dim=-1)


class SpeakerEncoder(nn.Module):
    """Mel (B, T, mel_bins) -> L2-normalised embedding (B, embedding_dim)
    fp32. With `input_lengths` the pooling covers each row's first
    (length + 1) // 2 output frames (the stride-2 front end)."""

    def __init__(self, config: SpeakerEncoderConfig):
        super().__init__()
        self.config = cfg = config
        dtype = cfg.compute_dtype
        self.temporal_binding = TemporalBindingLayer(cfg.mel_bins, cfg.d_model, dtype=dtype)
        self.local_ssm = LocalSSMProcessor(
            cfg.d_model, cfg.ssm_layers, cfg.ssm_state_dim, cfg.ssm_expand_ratio,
            cfg.ssm_kernel_size, cfg.scan_mode, dtype, cfg.dropout)
        self.emb_proj = Dense(2 * cfg.d_model, cfg.embedding_dim, dtype=torch.float32)

    def forward(self, mel: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.local_ssm(self.temporal_binding(mel), rng=rng)
        t2 = feats.shape[1]
        if input_lengths is None:
            valid = torch.ones(feats.shape[0], t2, dtype=torch.bool, device=feats.device)
        else:
            out_len = (torch.as_tensor(input_lengths, device=feats.device) + 1) // 2
            valid = torch.arange(t2, device=feats.device)[None, :] < out_len[:, None]
        emb = self.emb_proj(masked_stats_pool(feats, valid))
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-8)


class SpeakerClassifier(nn.Module):
    """``SpeakerEncoder`` + cosine classifier: returns (embeddings, cosine
    logits against the row-normalised ``class_weights``); the loss applies
    the margin and scale."""

    def __init__(self, config: SpeakerEncoderConfig):
        super().__init__()
        self.config = config
        self.encoder = SpeakerEncoder(config)
        self.class_weights = nn.Parameter(torch.zeros(config.n_speakers, config.embedding_dim))

    def forward(self, mel: torch.Tensor, input_lengths: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None):
        emb = self.encoder(mel, input_lengths, rng=rng)
        w = self.class_weights
        wn = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-8)
        return emb, emb @ wn.T


def create_speaker_model(config: Optional[SpeakerEncoderConfig] = None, device="cuda",
                         generator: Optional[torch.Generator] = None) -> SpeakerClassifier:
    """A freshly initialised ``SpeakerClassifier`` on `device`, drawn from
    the JAX package's distributions: the encoder modules as
    ``models.model.init_parameters`` draws them, ``emb_proj`` flax's
    default (lecun-normal, bias 0), ``class_weights`` N(0, 0.05). The
    draws come from `generator` (a CPU generator; None: seeded with 0)."""
    from .models.model import init_parameters, lecun_normal_

    device = resolve_device(device)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model = init_parameters(SpeakerClassifier(config or SpeakerEncoderConfig()), generator)
    with torch.no_grad():
        lecun_normal_(model.encoder.emb_proj.weight, generator)
        nn.init.normal_(model.class_weights, std=0.05, generator=generator)
    return model.to(device)


def am_softmax_per_row(cos: torch.Tensor, labels: torch.Tensor, margin: float,
                       scale: float) -> torch.Tensor:
    """Each row's cross entropy of scale * (cos - margin * onehot), (B,)."""
    onehot = F.one_hot(labels.to(torch.int64), cos.shape[-1]).to(torch.float32)
    logits = scale * (cos - margin * onehot)
    return -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def am_softmax_loss(cos: torch.Tensor, labels: torch.Tensor, margin: float, scale: float,
                    n_valid=None) -> torch.Tensor:
    """Additive-margin softmax over cosine logits (B, C): the mean over
    rows (the first n_valid rows where given) of ``am_softmax_per_row``."""
    per = am_softmax_per_row(cos, labels, margin, scale)
    if n_valid is None:
        return per.mean()
    w = (torch.arange(per.shape[0], device=per.device) < n_valid).to(torch.float32)
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


class SpeakerTrainer(Trainer):
    """``Trainer`` whose objective is the AM-softmax speaker
    classification of a ``SpeakerClassifier``; batches are the ASR
    collator's with the speaker id in ``targets[:, 0]``. SpecAugment acts
    only where ``augment.enabled``."""

    def __init__(self, model: SpeakerClassifier, config, train_iter, eval_batches=None,
                 **kwargs):
        if config.streaming_chunks:
            raise ValueError(
                "the streaming-aware objective is an ASR feature; speaker "
                "training does not support training.streaming_chunks"
            )
        super().__init__(model, config, train_iter, eval_batches, **kwargs)

    def _loss(self, batch: Dict[str, torch.Tensor], rng: Optional[torch.Generator]):
        from .augment import spec_augment

        batch = self._augment_waveform(batch, rng)
        mel, _ = self._batch_mel(batch)
        lengths = batch["input_lengths"]
        aug = self.config.augment
        if rng is not None and aug is not None and aug.enabled:
            mel = spec_augment(mel, rng, aug, lengths)
        _, cos = self.model(mel, input_lengths=lengths, rng=rng)
        cfg = self.model.config
        return self._row_mean(am_softmax_per_row(cos, batch["targets"][:, 0], cfg.am_margin,
                                                 cfg.am_scale))


# ----- artifacts --------------------------------------------------------------


def save_speaker_artifact(save_path: str, config: SpeakerEncoderConfig,
                          model: SpeakerClassifier) -> None:
    """Write the classifier (encoder subtree and class weights) in the
    ``save_pretrained`` layout, tagged ``objective: speaker_embedding``."""
    from .models.model import save_pretrained

    save_pretrained(save_path, config, model, extra={"objective": SPEAKER_OBJECTIVE})


def is_speaker_artifact(path: str) -> bool:
    config_file = os.path.join(path, "config.json")
    if not os.path.exists(config_file):
        return False
    with open(config_file) as f:
        return json.load(f).get("objective") == SPEAKER_OBJECTIVE


def load_speaker_artifact(path: str) -> Tuple[SpeakerEncoderConfig, Dict[str, Any]]:
    """(config, the classifier's flax parameter tree with numpy leaves);
    the encoder's subtree for inference is tree["encoder"]."""
    from .models.model import CONFIG_FILE, PARAMS_FILE

    with open(os.path.join(path, CONFIG_FILE)) as f:
        payload = json.load(f)
    if payload.get("objective") != SPEAKER_OBJECTIVE:
        raise ValueError(f"{path} is not a speaker-embedding artifact")
    config = SpeakerEncoderConfig.from_dict(payload.get("config", {}))
    return config, read_params(os.path.join(path, PARAMS_FILE))


# ----- VAD + windowing (host-side, cheap) --------------------------------------


def energy_vad(mel_raw: np.ndarray, threshold: float = 0.35, min_speech_s: float = 0.25,
               min_gap_s: float = 0.35) -> np.ndarray:
    """Frame-level speech mask from an un-normalised log-mel: the per-frame
    mean energy above floor + threshold * (ceiling - floor), floor and
    ceiling its 10th and 95th percentiles; gaps shorter than min_gap_s
    closed, then islands shorter than min_speech_s dropped."""
    e = mel_raw.mean(axis=-1)
    floor = np.percentile(e, 10)
    ceil = np.percentile(e, 95)
    if ceil - floor < 1e-3:
        return np.zeros(len(e), bool)  # silence or constant signal
    speech = e > floor + threshold * (ceil - floor)

    def _runs(mask: np.ndarray, value: bool):
        idx = np.flatnonzero(np.diff(np.r_[False, mask == value, False].astype(np.int8)))
        return list(zip(idx[::2], idx[1::2]))

    min_gap = int(round(min_gap_s / FRAME_S))
    for s, t in _runs(speech, False):
        if 0 < s and t < len(speech) and t - s < min_gap:
            speech[s:t] = True
    min_speech = int(round(min_speech_s / FRAME_S))
    for s, t in _runs(speech, True):
        if t - s < min_speech:
            speech[s:t] = False
    return speech


def speech_regions(speech: np.ndarray) -> List[Tuple[int, int]]:
    """[(start_frame, end_frame)) runs of True."""
    idx = np.flatnonzero(np.diff(np.r_[False, speech.astype(bool), False].astype(np.int8)))
    return list(zip(idx[::2], idx[1::2]))


def window_plan(regions: Sequence[Tuple[int, int]], window: int,
                hop: int) -> List[Tuple[int, int]]:
    """[(start_frame, valid_frames)] sliding windows over speech regions:
    one partial window for a region no longer than `window`, else windows
    every `hop` frames and one flush with the region's end."""
    plan: List[Tuple[int, int]] = []
    for s, t in regions:
        n = t - s
        if n <= 0:
            continue
        if n <= window:
            plan.append((s, n))
            continue
        starts = list(range(s, t - window + 1, hop))
        if starts[-1] + window < t:
            starts.append(t - window)
        plan.extend((st, window) for st in starts)
    return plan


# ----- DER ---------------------------------------------------------------------


def _as_tuples(segs) -> List[Tuple[float, float, Any]]:
    out = []
    for s in segs:
        if isinstance(s, dict):
            out.append((float(s["start"]), float(s["end"]), s["speaker"]))
        else:
            out.append((float(s[0]), float(s[1]), s[2]))
    return [(a, b, spk) for a, b, spk in out if b > a]


def diarization_error_rate(reference, hypothesis, collar: float = 0.25) -> Dict[str, float]:
    """DER with the optimal speaker mapping and a collar of +-collar
    seconds around every reference boundary (NIST md-eval's convention).
    reference / hypothesis: {"start", "end", "speaker"} dicts or (start,
    end, speaker) tuples; overlap counts by set cardinality. Returns
    {"der", "miss", "false_alarm", "confusion", "total"} in seconds."""
    from scipy.optimize import linear_sum_assignment

    ref = _as_tuples(reference)
    hyp = _as_tuples(hypothesis)
    excl: List[Tuple[float, float]] = []
    if collar > 0:
        for a, b, _ in ref:
            excl.append((a - collar, a + collar))
            excl.append((b - collar, b + collar))
    bounds = sorted({x for a, b, _ in ref + hyp for x in (a, b)} | {x for e in excl for x in e})
    ref_spk = sorted({s for _, _, s in ref}, key=str)
    hyp_spk = sorted({s for _, _, s in hyp}, key=str)
    r_ix = {s: i for i, s in enumerate(ref_spk)}
    h_ix = {s: i for i, s in enumerate(hyp_spk)}

    def _atoms():
        for t0, t1 in zip(bounds, bounds[1:]):
            if t1 - t0 <= 1e-9:
                continue
            mid = 0.5 * (t0 + t1)
            if any(a < mid < b for a, b in excl):
                continue
            r = {s for a, b, s in ref if a <= mid < b}
            h = {s for a, b, s in hyp if a <= mid < b}
            yield t1 - t0, r, h

    overlap = np.zeros((max(len(ref_spk), 1), max(len(hyp_spk), 1)))
    for dur, r, h in _atoms():
        for s in r:
            for q in h:
                overlap[r_ix[s], h_ix[q]] += dur
    rows, cols = linear_sum_assignment(-overlap)
    mapping = {hyp_spk[c]: ref_spk[r] for r, c in zip(rows, cols)
               if r < len(ref_spk) and c < len(hyp_spk) and overlap[r, c] > 0}
    miss = fa = conf = total = 0.0
    for dur, r, h in _atoms():
        total += dur * len(r)
        n_r, n_h = len(r), len(h)
        matched = sum(1 for q in h if mapping.get(q) in r)
        miss += dur * max(0, n_r - n_h)
        fa += dur * max(0, n_h - n_r)
        conf += dur * (min(n_r, n_h) - matched)
    der = (miss + fa + conf) / total if total > 0 else 0.0
    return {"der": der, "miss": miss, "false_alarm": fa, "confusion": conf, "total": total}


# ----- the diarization pipeline -------------------------------------------------


@dataclass
class DiarizeConfig:
    """The pipeline's knobs (the JAX package's defaults, tuned on the dev
    conversation split there)."""

    window_s: float = 1.5
    hop_s: float = 0.4
    vad_threshold: float = 0.15  # energy-VAD relative threshold
    min_speech_s: float = 0.25
    min_gap_s: float = 0.35
    cluster_threshold: float = 0.45  # AHC cosine-distance cut, count unknown
    refine_iters: int = 2  # nearest-centroid passes after clustering (0: none)
    cluster_method: str = "spectral"  # or "ahc"
    max_speakers: int = 8  # spectral count-search ceiling
    batch_bucket: int = 64  # windows a device call


@dataclass
class Segment:
    start: float
    end: float
    speaker: int
    text: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"start": self.start, "end": self.end, "speaker": self.speaker}
        if self.text is not None:
            d["text"] = self.text
        return d


def _first_appearance(labels) -> np.ndarray:
    """Labels renumbered 0..K-1 in order of first appearance."""
    remap: Dict[int, int] = {}
    out = np.empty(len(labels), np.int32)
    for i, lab in enumerate(labels):
        if int(lab) not in remap:
            remap[int(lab)] = len(remap)
        out[i] = remap[int(lab)]
    return out


def cluster_embeddings(emb: np.ndarray, n_speakers: Optional[int] = None,
                       threshold: float = 0.45) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance, cut at
    n_speakers clusters or at `threshold`; 0-based labels (N,)."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import pdist

    n = emb.shape[0]
    if n <= 1:
        return np.zeros(n, np.int32)
    z = linkage(pdist(emb.astype(np.float64), metric="cosine"), method="average")
    if n_speakers is not None:
        labels = fcluster(z, min(n_speakers, n), criterion="maxclust")
    else:
        labels = fcluster(z, threshold, criterion="distance")
    return _first_appearance(labels)


def reassign_to_centroids(emb: np.ndarray, labels: np.ndarray, iters: int = 2) -> np.ndarray:
    """Move each window to its nearest cluster centroid under cosine
    similarity, recomputing the centroids, up to `iters` passes (a cluster
    may empty); labels renumbered in order of first appearance."""
    lab = labels.astype(np.int32, copy=True)
    if lab.size <= 1 or iters <= 0:
        return lab
    x = emb.astype(np.float64)
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-12
    for _ in range(iters):
        ks = sorted(set(lab.tolist()))
        if len(ks) < 2:
            break
        cents = np.stack([x[lab == kk].mean(axis=0) for kk in ks])
        cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-12
        new = np.asarray(ks, np.int32)[np.argmax(x @ cents.T, axis=1)]
        if (new == lab).all():
            break
        lab = new
    return _first_appearance(lab)


def _kmeans(x: np.ndarray, k: int, restarts: int = 10, iters: int = 50,
            seed: int = 0) -> np.ndarray:
    """The best of `restarts` k-means++ runs, restart r seeded seed + r."""
    n = x.shape[0]
    k = min(k, n)
    best_labels, best_inertia = None, np.inf
    for r in range(restarts):
        rng = np.random.default_rng(seed + r)
        centers = [x[rng.integers(n)]]
        for _ in range(1, k):
            d2 = np.min(((x[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1)
            tot = d2.sum()
            if tot <= 1e-12:
                centers.append(x[rng.integers(n)])
                continue
            centers.append(x[rng.choice(n, p=d2 / tot)])
        c = np.asarray(centers)
        labels = np.zeros(n, np.int32)
        for it in range(iters):
            d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
            new_labels = d2.argmin(axis=1).astype(np.int32)
            if (new_labels == labels).all() and it > 0:
                break
            labels = new_labels
            for j in range(k):
                sel = labels == j
                if sel.any():
                    c[j] = x[sel].mean(axis=0)
        inertia = float(((x - c[labels]) ** 2).sum())
        if inertia < best_inertia:
            best_inertia, best_labels = inertia, labels
    return best_labels


def _mean_silhouette(emb: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient on cosine distance; -1 below two
    clusters."""
    x = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    d = 1.0 - x @ x.T
    ks = sorted(set(labels.tolist()))
    if len(ks) < 2:
        return -1.0
    n = len(labels)
    s = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = d[i][same].mean() if same.any() else 0.0
        b = min(d[i][labels == kk].mean() for kk in ks if kk != labels[i])
        s[i] = (b - a) / max(a, b, 1e-12)
    return float(s.mean())


def spectral_cluster_embeddings(emb: np.ndarray, n_speakers: Optional[int] = None,
                                max_speakers: int = 8, graph_density: float = 0.2,
                                min_silhouette: float = 0.15) -> np.ndarray:
    """Spectral clustering of a binarised, symmetrised top-p cosine
    neighbour graph (p = graph_density * n): k-means on the rows of the
    Laplacian's first k eigenvectors, k pinned by n_speakers or chosen by
    the best mean silhouette of the embeddings over 2..max_speakers (one
    speaker below min_silhouette). Labels in order of first appearance."""
    n = emb.shape[0]
    if n <= 1:
        return np.zeros(n, np.int32)
    x = emb.astype(np.float64)
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-12
    aff = x @ x.T
    np.fill_diagonal(aff, 0.0)
    p = int(min(max(2, round(graph_density * n)), n - 1))
    a_p = np.zeros_like(aff)
    idx = np.argpartition(aff, n - p, axis=1)[:, n - p:]
    a_p[np.repeat(np.arange(n), p), idx.ravel()] = 1.0
    a_p = 0.5 * (a_p + a_p.T)
    lap = np.diag(a_p.sum(axis=1)) - a_p
    _, vecs = np.linalg.eigh(lap)

    def cluster_at(k: int) -> np.ndarray:
        feats = vecs[:, :k]
        feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-12)
        return _kmeans(feats, k)

    if n_speakers is not None:
        k = min(n_speakers, n)
        labels = cluster_at(k) if k > 1 else np.zeros(n, np.int32)
    else:
        best_labels, best_s = None, -1.0
        for k in range(2, int(min(max_speakers, n - 1)) + 1):
            cand = cluster_at(k)
            s = _mean_silhouette(emb, cand)
            if s > best_s:
                best_labels, best_s = cand, s
        if best_labels is None or best_s < min_silhouette:
            return np.zeros(n, np.int32)
        labels = best_labels
    return _first_appearance(labels)


class Diarizer:
    """Diarization with a trained speaker encoder on `device` (the card
    unless told otherwise): the windows of a file are embedded at most
    ``batch_bucket`` a call (rows are independent, so the last call takes
    the rest unpadded); VAD, clustering and segment assembly are host
    numpy."""

    def __init__(self, model_dir: Optional[str] = None, *,
                 encoder_config: Optional[SpeakerEncoderConfig] = None,
                 encoder_params: Optional[Dict[str, Any]] = None,
                 config: Optional[DiarizeConfig] = None, device="cuda"):
        if model_dir is not None:
            encoder_config, params = load_speaker_artifact(model_dir)
            encoder_params = params["encoder"]
        if encoder_config is None or encoder_params is None:
            raise ValueError("Diarizer needs model_dir or (encoder_config, encoder_params)")
        self.encoder_config = encoder_config
        self.config = config or DiarizeConfig()
        self.device = resolve_device(device)
        self.encoder = SpeakerEncoder(encoder_config)  # encoder_params: the flax subtree
        self.encoder.load_state_dict(params_from_numpy(encoder_params), strict=True)
        self.encoder.to(self.device).eval()

    @property
    def window_frames(self) -> int:
        return int(round(self.config.window_s / FRAME_S))

    @property
    def hop_frames(self) -> int:
        return max(int(round(self.config.hop_s / FRAME_S)), 1)

    @torch.inference_mode()
    def _embed(self, windows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Each window normalised over its valid cells by one scalar mean
        and population std (the statistics ``scalar_normalize_mel`` gives
        the encoder in training), invalid cells zeroed, then embedded."""
        t, nb = windows.shape[1], windows.shape[2]
        m = (torch.arange(t, device=windows.device)[None, :] < lengths[:, None])
        m = m.to(torch.float32)[..., None]
        n = torch.clamp(m.sum(dim=(1, 2), keepdim=True) * nb, min=1.0)
        mean = (windows * m).sum(dim=(1, 2), keepdim=True) / n
        var = (((windows - mean) ** 2) * m).sum(dim=(1, 2), keepdim=True) / n
        normed = (windows - mean) / (torch.sqrt(var) + 1e-5) * m
        return self.encoder(normed, input_lengths=lengths)

    def embed_windows(self, mel_raw: np.ndarray, plan: Sequence[Tuple[int, int]]) -> np.ndarray:
        """Embed the planned windows of an un-normalised mel (T, mel_bins):
        (len(plan), embedding_dim) fp32."""
        dim = self.encoder_config.embedding_dim
        if not plan:
            return np.zeros((0, dim), np.float32)
        w = self.window_frames
        n = len(plan)
        windows = np.zeros((n, w, mel_raw.shape[1]), np.float32)
        lengths = np.zeros((n,), np.int64)
        for i, (start, valid) in enumerate(plan):
            seg = mel_raw[start:min(start + min(valid, w), mel_raw.shape[0])]
            windows[i, : seg.shape[0]] = seg
            lengths[i] = seg.shape[0]
        out = np.zeros((n, dim), np.float32)
        bucket = self.config.batch_bucket
        for ofs in range(0, n, bucket):
            chunk = torch.from_numpy(windows[ofs:ofs + bucket]).to(self.device)
            lens = torch.from_numpy(lengths[ofs:ofs + bucket]).to(self.device)
            out[ofs:ofs + bucket] = self._embed(chunk, lens).cpu().numpy()
        return out

    def diarize(self, audio: np.ndarray, n_speakers: Optional[int] = None) -> List[Segment]:
        """Audio (16 kHz mono float) -> speaker-labelled segments."""
        cfg = self.config
        mel_raw = compute_mel_spectrogram_np(audio, normalize=False)
        speech = energy_vad(mel_raw, cfg.vad_threshold, cfg.min_speech_s, cfg.min_gap_s)
        plan = window_plan(speech_regions(speech), self.window_frames, self.hop_frames)
        emb = self.embed_windows(mel_raw, plan)
        if cfg.cluster_method == "spectral":
            labels = spectral_cluster_embeddings(emb, n_speakers=n_speakers,
                                                 max_speakers=cfg.max_speakers)
        elif cfg.cluster_method == "ahc":
            labels = cluster_embeddings(emb, n_speakers=n_speakers,
                                        threshold=cfg.cluster_threshold)
        else:
            raise ValueError(f"unknown cluster_method {cfg.cluster_method!r} "
                             "(expected 'spectral' or 'ahc')")
        if labels.size and labels.max() > 0:
            refined = reassign_to_centroids(emb, labels, cfg.refine_iters)
            # a pinned count is a contract: keep the unrefined partition
            # if the centroid pass emptied a cluster
            if n_speakers is None or len(set(refined.tolist())) == len(set(labels.tolist())):
                labels = refined

        # frame-level majority vote over the covering windows, then runs of
        # one label over the frames the VAD marked as speech
        n_clusters = int(labels.max()) + 1 if labels.size else 0
        votes = np.zeros((mel_raw.shape[0], max(n_clusters, 1)), np.int32)
        for (start, valid), lab in zip(plan, labels):
            votes[start:start + valid, lab] += 1
        active = speech & (votes.sum(axis=1) > 0)
        frame_lab = votes.argmax(axis=1)
        segs: List[Segment] = []
        prev, seg_start = None, 0
        for t in range(len(active) + 1):
            cur = int(frame_lab[t]) if t < len(active) and active[t] else None
            if cur != prev:
                if prev is not None:
                    segs.append(Segment(seg_start * FRAME_S, t * FRAME_S, prev))
                seg_start, prev = t, cur
        return segs


# ----- the CLI (scripts/diarize.py) ---------------------------------------------


def speaker_training(args):
    """The train command's (model config, TrainingConfig, train loader, eval
    loader): ``SyntheticSpeakerDataset`` voices (the eval split: the same
    voices, other utterances), warmup min(500, steps / 10), a log every 50
    micro-steps into ``metrics.jsonl``."""
    from .data import ASRCollator, DataLoader
    from .synth import SyntheticSpeakerDataset
    from .training import TrainingConfig

    cfg = SpeakerEncoderConfig(n_speakers=args.num_speakers, d_model=args.d_model,
                               ssm_layers=args.layers, embedding_dim=args.embedding_dim,
                               dtype="bfloat16" if args.bf16 else "float32",
                               scan_mode=args.scan_mode)
    words = {"seed": args.seed, "min_words": args.min_words, "max_words": args.max_words}
    train_ds = SyntheticSpeakerDataset(n_speakers=args.num_speakers,
                                       utts_per_speaker=args.utts_per_speaker, split="train",
                                       **words)
    eval_ds = SyntheticSpeakerDataset(n_speakers=args.num_speakers,
                                      utts_per_speaker=max(args.utts_per_speaker // 10, 2),
                                      split="eval", **words)
    collator = ASRCollator(frame_bucket=args.frame_bucket, target_bucket=1)
    train_loader = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                              num_workers=args.num_workers, collate_fn=collator,
                              drop_last=True, seed=args.seed, prefetch=4)
    eval_loader = DataLoader(eval_ds, batch_size=args.batch_size, shuffle=False,
                             num_workers=args.num_workers, collate_fn=collator)
    train_cfg = TrainingConfig(
        learning_rate=args.lr, warmup_steps=min(500, args.steps // 10), max_steps=args.steps,
        batch_size=args.batch_size, gradient_accumulation_steps=args.grad_accum,
        log_interval=50, eval_interval=max(args.steps // 6, 100),
        save_interval=max(args.steps // 2, 500), checkpoint_dir=args.checkpoint_dir,
        metrics_path=os.path.join(args.checkpoint_dir, "metrics.jsonl"))
    return cfg, train_cfg, train_loader, eval_loader


def cmd_train(args) -> SpeakerTrainer:
    from .data import cycle

    device = resolve_device(args.device)
    cfg, train_cfg, train_loader, eval_loader = speaker_training(args)
    logger.info("Speaker encoder config: %s", cfg)
    model = create_speaker_model(cfg, device=device)
    batches = cycle(train_loader)
    trainer = SpeakerTrainer(model, train_cfg, batches, lambda: iter(eval_loader))
    logger.info("Parameters: %s", f"{sum(p.numel() for p in model.parameters()):,}")
    try:
        trainer.train()
    finally:
        batches.close()  # stops the loader's worker processes
    artifact = os.path.join(args.checkpoint_dir, "final_speaker")
    save_speaker_artifact(artifact, cfg, model)
    logger.info("Saved speaker artifact to %s", artifact)
    return trainer


def _diarize_config(args) -> DiarizeConfig:
    kw = dict(cluster_threshold=args.cluster_threshold, cluster_method=args.cluster_method,
              max_speakers=args.max_cluster_speakers, refine_iters=args.refine_iters)
    if args.vad_threshold is not None:
        kw["vad_threshold"] = args.vad_threshold
    return DiarizeConfig(**kw)


def evaluate_conversations(diar: Diarizer, conversations, known_speakers: bool,
                           collar: float = 0.25) -> dict:
    """DER over conversations ({"audio", "segments", "n_speakers"} items,
    e.g. a ``SyntheticConversationDataset``), the speaker count pinned to
    the truth with `known_speakers`: the aggregate of the eval command."""
    results = []
    for i in range(len(conversations)):
        item = conversations[i]
        n_spk = item["n_speakers"] if known_speakers else None
        hyp = [s.to_dict() for s in diar.diarize(item["audio"], n_speakers=n_spk)]
        der = diarization_error_rate(item["segments"], hyp, collar=collar)
        der["n_speakers_ref"] = item["n_speakers"]
        der["n_speakers_hyp"] = len({s["speaker"] for s in hyp})
        results.append(der)
        logger.info("conv %02d: DER %.2f%% (miss %.2fs fa %.2fs conf %.2fs / %.1fs) "
                    "ref_spk=%d hyp_spk=%d", i, 100 * der["der"], der["miss"],
                    der["false_alarm"], der["confusion"], der["total"],
                    der["n_speakers_ref"], der["n_speakers_hyp"])
    total = sum(r["total"] for r in results)
    return {
        "der": sum(r["miss"] + r["false_alarm"] + r["confusion"] for r in results)
        / max(total, 1e-9),
        "miss_rate": sum(r["miss"] for r in results) / max(total, 1e-9),
        "fa_rate": sum(r["false_alarm"] for r in results) / max(total, 1e-9),
        "confusion_rate": sum(r["confusion"] for r in results) / max(total, 1e-9),
        "mean_der": float(np.mean([r["der"] for r in results])),
        "speaker_count_accuracy": float(
            np.mean([r["n_speakers_hyp"] == r["n_speakers_ref"] for r in results])),
        "n_conversations": len(results),
        "total_speech_s": total,
    }


def cmd_eval(args) -> dict:
    from .synth import SyntheticConversationDataset

    ds = SyntheticConversationDataset(n_convs=args.num_convs,
                                      speakers_range=(args.min_speakers, args.max_speakers),
                                      split=args.split, seed=args.seed)
    diar = Diarizer(args.speaker_model, config=_diarize_config(args), device=args.device)
    agg = evaluate_conversations(diar, ds, args.known_speakers, args.collar)
    agg.update({"collar": args.collar, "known_speakers": bool(args.known_speakers),
                "cluster_method": args.cluster_method, "speaker_model": args.speaker_model})
    logger.info("Aggregate DER %.2f%% (miss %.2f%% fa %.2f%% conf %.2f%%) over %d "
                "conversations, %.0fs speech; speaker-count accuracy %.0f%%",
                100 * agg["der"], 100 * agg["miss_rate"], 100 * agg["fa_rate"],
                100 * agg["confusion_rate"], agg["n_conversations"], agg["total_speech_s"],
                100 * agg["speaker_count_accuracy"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(agg, f, indent=2)
        logger.info("Wrote %s", args.out)
    return agg


def cmd_files(args) -> list:
    from .audio import load_audio

    diar = Diarizer(args.speaker_model, config=_diarize_config(args), device=args.device)
    transcriber = None
    if args.asr_model:
        from .transcribe import load_transcriber

        transcriber = load_transcriber(args.asr_model, device=args.device)
    out = []
    for path in args.audio:
        try:
            audio = np.asarray(load_audio(path), np.float32)
            segs = diar.diarize(audio, n_speakers=args.num_speakers)
            if transcriber is not None and segs:
                clips = [audio[int(s.start * SAMPLE_RATE): int(s.end * SAMPLE_RATE)]
                         for s in segs]
                for s, r in zip(segs, transcriber.transcribe_batch(clips)):
                    s.text = r["text"]
            out.append({"file": path, "segments": [s.to_dict() for s in segs]})
        except Exception as e:  # per-file isolation, as transcribe does
            logger.error("%s failed: %s", path, e)
            out.append({"file": path, "error": str(e)})
    if args.json or args.output:
        payload = json.dumps(out, indent=2)
        if args.output:
            with open(args.output, "w") as f:
                f.write(payload)
        else:
            print(payload)
    else:
        for rec in out:
            print(rec["file"])
            for s in rec.get("segments", []):
                line = f"  [{s['start']:8.2f} - {s['end']:8.2f}] spk{s['speaker']}"
                if "text" in s:
                    line += f": {s['text']}"
                print(line)
    return out


def _clustering_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cluster-threshold", type=float, default=0.45)
    p.add_argument("--cluster-method", choices=["spectral", "ahc"], default="spectral",
                   help="spectral = kNN-graph spectral clustering with a silhouette-chosen "
                        "count (default); ahc = agglomerative threshold cut")
    p.add_argument("--max-cluster-speakers", type=int, default=8,
                   help="spectral count-search ceiling")
    p.add_argument("--vad-threshold", type=float, default=None,
                   help="energy-VAD relative threshold (default: DiarizeConfig.vad_threshold)")
    p.add_argument("--refine-iters", type=int, default=2,
                   help="nearest-centroid reassignment passes after clustering (0 disables)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="VELOCITY-ASR speaker diarization "
                                                 "(PyTorch port)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the speaker-embedding encoder")
    t.add_argument("--checkpoint-dir", default="./checkpoints/speaker_run")
    t.add_argument("--num-speakers", type=int, default=64)
    t.add_argument("--utts-per-speaker", type=int, default=200)
    t.add_argument("--steps", type=int, default=3000)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--grad-accum", type=int, default=1)
    t.add_argument("--scan-mode", default="parallel",
                   choices=["sequential", "parallel", "pallas"],
                   help="parallel and pallas both run the scan kernels on the card")
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--d-model", type=int, default=128)
    t.add_argument("--layers", type=int, default=4)
    t.add_argument("--embedding-dim", type=int, default=128)
    t.add_argument("--frame-bucket", type=int, default=100)
    t.add_argument("--bf16", action="store_true")
    t.add_argument("--seed", type=int, default=1234)
    t.add_argument("--min-words", type=int, default=2)
    t.add_argument("--max-words", type=int, default=6)
    t.add_argument("--num-workers", type=int, default=8,
                   help="data loader worker processes (0: load in this process)")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="synthetic-conversation DER benchmark")
    e.add_argument("--speaker-model", required=True)
    e.add_argument("--num-convs", type=int, default=20)
    e.add_argument("--min-speakers", type=int, default=2)
    e.add_argument("--max-speakers", type=int, default=4)
    e.add_argument("--split", default="test")
    e.add_argument("--seed", type=int, default=1234)
    e.add_argument("--collar", type=float, default=0.25)
    _clustering_flags(e)
    e.add_argument("--known-speakers", action="store_true",
                   help="give the clusterer the true speaker count")
    e.add_argument("--out", help="write aggregate JSON here")
    e.set_defaults(fn=cmd_eval)

    f = sub.add_parser("files", help="diarize audio files")
    f.add_argument("audio", nargs="+")
    f.add_argument("--speaker-model", required=True)
    f.add_argument("--asr-model", help="ASR checkpoint: adds per-segment transcripts")
    f.add_argument("--num-speakers", type=int, default=None,
                   help="pin the speaker count (default: infer)")
    _clustering_flags(f)
    f.add_argument("--json", action="store_true")
    f.add_argument("--output")
    f.set_defaults(fn=cmd_files)

    for p in (t, e, f):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)s | %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    main()
