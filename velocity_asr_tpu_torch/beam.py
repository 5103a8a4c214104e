"""CTC prefix beam search on the logits' device (mirrors velocity_asr_tpu/beam.py).

The reference prefix beam: hypotheses keyed by their prefix, max-merge
(not logsumexp) of hypotheses that collapse to the same prefix, and the
surviving hypothesis carries its own last token. Each frame is a few
(batch, beams x vocab) tensor ops and two stable sorts; the batch axis
replaces the JAX package's ``vmap`` and a Python loop over frames its
``lax.scan``. Beam search has no Pallas kernel in the JAX package, so it
has no hand-written kernel here: every op is a stock torch call.

Prefix identity is tracked with two independent 32-bit rolling hashes
that wrap as uint32 does. They are carried as int64 masked to 32 bits
after every multiply-add (P2 < 2^30, so the products fit), because
torch's uint32 arithmetic and sort are incomplete on CUDA.

Ties decide which hypothesis survives, so they are broken as the JAX
package breaks them: its lexsort and argsort are stable (ties in flat
candidate order) and its top_k puts the lower index first, here a
stable sort each.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30

_P1 = 1000003
_P2 = 998244353
_MASK32 = 0xFFFFFFFF


def _hash_step(h: torch.Tensor, p: int, v: torch.Tensor) -> torch.Tensor:
    """(h * p + v + 1) mod 2^32 on int64 values in [0, 2^32)."""
    return (h * p + v + 1) & _MASK32


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, i]] for (batch, k, ...) t and (batch, k) idx."""
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx[:, :, None].expand(-1, -1, t.shape[2]))


def _beam_frame_step(state: Tuple, lp_t: torch.Tensor, blank_token: int,
                     t=None, track: Optional[Tuple] = None):
    """One frame of the prefix beam on (batch, k, ...) state tensors.

    state = (prefixes (batch, k, cap) int32, lengths, scores, last, h1,
    h2); lp_t (batch, vocab) fp32 log posteriors. The prefix buffer
    capacity `cap` is whatever the caller allocated (the one-shot search
    uses cap = T; the streaming path keeps a smaller rolling buffer and
    commits the beams' common prefix out of it).

    track (optional, with `t` the absolute frame index: an int or a
    (batch,) tensor) carries per-token frame spans and log posteriors
    along each hypothesis's own trajectory: (starts, ends, lp_sum, lp_n)
    each (batch, k, cap) aligned with the prefix buffer, plus (tail_end,
    tail_lp, tail_n) each (batch, k) for frames that extend the last
    committed token (its slot was shifted out by beam_commit). A token's
    span starts at its emission frame and ends one past the last
    consecutive frame of the token (a repeat keeps the run open; blank
    freezes it): the greedy collapse's spans wherever the hypothesis's
    choices match the argmax.

    Returns (new_state, dropped, new_track): `dropped` (batch,) bool is
    set where some kept hypothesis tried to extend past `cap`. Lengths
    are clamped to `cap`, so overflow is a clean truncation.
    """
    prefixes, lengths, scores, last, h1, h2 = state
    batch, k, cap = prefixes.shape
    vocab = lp_t.shape[-1]
    device = lp_t.device
    vocab_ids = torch.arange(vocab, dtype=torch.int32, device=device)

    # candidate grid (batch, k, vocab)
    cand_scores = scores[:, :, None] + lp_t[:, None, :]
    extends = (vocab_ids != blank_token)[None, None, :] & (vocab_ids[None, None, :]
                                                           != last[:, :, None])
    v64 = vocab_ids.to(torch.int64)[None, None, :]
    c_h1 = torch.where(extends, _hash_step(h1[:, :, None], _P1, v64), h1[:, :, None])
    c_h2 = torch.where(extends, _hash_step(h2[:, :, None], _P2, v64), h2[:, :, None])

    flat_scores = cand_scores.reshape(batch, k * vocab)
    flat_h1 = c_h1.reshape(batch, k * vocab)
    flat_h2 = c_h2.reshape(batch, k * vocab)

    # Max-merge candidates sharing a prefix: the JAX package's stable
    # lexsort by (h1, h2, -score) as two stable sorts, the last key first;
    # (h1, h2) as one order-preserving int64 key. Keep the first (best)
    # of each hash group.
    _, order = torch.sort(-flat_scores, dim=1, stable=True)
    key = (flat_h1 - (1 << 31)) * (1 << 32) + flat_h2
    _, by_key = torch.sort(torch.gather(key, 1, order), dim=1, stable=True)
    order = torch.gather(order, 1, by_key)
    s_key = torch.gather(key, 1, order)
    s_scores = torch.gather(flat_scores, 1, order)
    first = torch.ones_like(s_key, dtype=torch.bool)
    first[:, 1:] = s_key[:, 1:] != s_key[:, :-1]
    merged_scores = torch.where(first, s_scores, torch.full_like(s_scores, NEG_INF))

    # prune to the beam width: top_k's tie order (lower index first)
    top_scores, top_pos = torch.sort(merged_scores, dim=1, descending=True, stable=True)
    top_scores, top_pos = top_scores[:, :k], top_pos[:, :k]
    sel = torch.gather(order, 1, top_pos)  # flat candidate index
    parent = sel // vocab
    tok = (sel % vocab).to(torch.int32)

    new_h1 = torch.gather(flat_h1, 1, sel)
    new_h2 = torch.gather(flat_h2, 1, sel)
    p_len = torch.gather(lengths, 1, parent)
    p_last = torch.gather(last, 1, parent)
    p_extends = (tok != blank_token) & (tok != p_last)
    new_len_raw = p_len + p_extends.to(torch.int32)
    dropped = (new_len_raw > cap).any(dim=1)
    new_len = torch.clamp(new_len_raw, max=cap)

    # prefix buffer: the parent's, with the new token written at p_len
    # where extended (p_len == cap matches no slot: the token is dropped)
    pos = torch.arange(cap, dtype=torch.int32, device=device)[None, None, :]
    write = (pos == p_len[:, :, None]) & p_extends[:, :, None]
    new_prefixes = torch.where(write, tok[:, :, None], _rows(prefixes, parent))

    new_state = (new_prefixes, new_len, top_scores, tok, new_h1, new_h2)
    if track is None:
        return new_state, dropped, None

    starts, ends, lp_sum, lp_n, tail_end, tail_lp, tail_n = track
    t32 = torch.as_tensor(t, dtype=torch.int32, device=device).reshape(-1, 1)
    t3 = t32[:, :, None]
    chosen_lp = torch.gather(lp_t, 1, tok.to(torch.int64))  # (batch, k)
    # a repeat of the parent's last token keeps that token's run open
    is_rep = (tok != blank_token) & (tok == p_last)
    write_rep = (pos == (p_len - 1)[:, :, None]) & is_rep[:, :, None]
    p_starts, p_ends = _rows(starts, parent), _rows(ends, parent)
    p_lp_sum, p_lp_n = _rows(lp_sum, parent), _rows(lp_n, parent)
    lp3 = chosen_lp[:, :, None]
    new_starts = torch.where(write, t3, p_starts)
    new_ends = torch.where(write | write_rep, t3 + 1, p_ends)
    new_lp_sum = torch.where(write, lp3, torch.where(write_rep, p_lp_sum + lp3, p_lp_sum))
    new_lp_n = torch.where(write, 1, torch.where(write_rep, p_lp_n + 1, p_lp_n)).to(torch.int32)
    # a repeat with an empty suffix buffer continues the last committed
    # token: the tail records it for the host
    rep_tail = is_rep & (p_len == 0)
    p_tail_end, p_tail_lp = _rows(tail_end, parent), _rows(tail_lp, parent)
    p_tail_n = _rows(tail_n, parent)
    new_tail_end = torch.where(rep_tail, t32 + 1, p_tail_end)
    new_tail_lp = torch.where(rep_tail, p_tail_lp + chosen_lp, p_tail_lp)
    new_tail_n = torch.where(rep_tail, p_tail_n + 1, p_tail_n)
    new_track = (new_starts, new_ends, new_lp_sum, new_lp_n,
                 new_tail_end, new_tail_lp, new_tail_n)
    return new_state, dropped, new_track


def _initial_beams(batch: int, k: int, cap: int, device) -> Tuple:
    """(prefixes, lengths, scores, last, h1, h2) of an empty beam: one live
    hypothesis (score 0, last token -1) in slot 0."""
    scores = torch.full((batch, k), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return (torch.full((batch, k, cap), -1, dtype=torch.int32, device=device),
            torch.zeros((batch, k), dtype=torch.int32, device=device),
            scores,
            torch.full((batch, k), -1, dtype=torch.int32, device=device),
            torch.zeros((batch, k), dtype=torch.int64, device=device),
            torch.zeros((batch, k), dtype=torch.int64, device=device))


@torch.inference_mode()
def ctc_beam_search_torch(logits: torch.Tensor, beam_width: int = 10,
                          blank_token: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beam search on the logits' device.

    Args:
        logits: (batch, T, vocab), unnormalised; any float dtype (the log
            posteriors are taken in fp32).

    Returns tokens (batch, beam_width, T) int32 padded with -1, lengths
    (batch, beam_width) int32 and scores (batch, beam_width) fp32 (log
    probability, max-merge), best first. Slots no hypothesis filled score
    NEG_INF.
    """
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    batch, t_len, _ = log_probs.shape
    state = _initial_beams(batch, beam_width, t_len, log_probs.device)
    for t in range(t_len):  # cap == T: the one-shot search cannot overflow
        state, _, _ = _beam_frame_step(state, log_probs[:, t], blank_token)
    prefixes, lengths, scores = state[:3]
    _, order = torch.sort(-scores, dim=1, stable=True)
    return _rows(prefixes, order), torch.gather(lengths, 1, order), torch.gather(scores, 1, order)


_RESUME_KEYS = ("prefixes", "lengths", "scores", "last", "h1", "h2",
                "starts", "ends", "lp_sum", "lp_n",
                "tail_end", "tail_lp", "tail_n", "overflow")


def beam_state_init(batch: int, beam_width: int, cap: int, device="cpu") -> dict:
    """Carried beam state for chunkwise (streaming) beam search.

    A dict of (batch, beam_width, ...) tensors on `device`, the keys of
    the JAX package's; `cap` is the prefix buffer's capacity in tokens
    (h1, h2 are int64 holding uint32 values). ctc_beam_resume advances it
    over one chunk of logits; beam_commit emits the beams' common prefix
    and shifts it out, so a live stream's buffer stays bounded. Rows stay
    sorted best first, so row 0 is always the current best hypothesis.
    """
    k = beam_width
    prefixes, lengths, scores, last, h1, h2 = _initial_beams(batch, k, cap, device)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "prefixes": prefixes, "lengths": lengths, "scores": scores, "last": last,
        "h1": h1, "h2": h2,
        # per-token frame spans and log posteriors along each hypothesis
        # (_beam_frame_step `track`)
        "starts": zeros(batch, k, cap), "ends": zeros(batch, k, cap),
        "lp_sum": zeros(batch, k, cap, dtype=torch.float32), "lp_n": zeros(batch, k, cap),
        "tail_end": zeros(batch, k), "tail_lp": zeros(batch, k, dtype=torch.float32),
        "tail_n": zeros(batch, k),
        # set once a hypothesis tried to write past `cap` (tokens were
        # dropped): the transcript is truncated
        "overflow": zeros(batch, dtype=torch.bool),
    }


@torch.inference_mode()
def ctc_beam_resume(state: dict, logits: torch.Tensor, valid, blank_token: int = 0,
                    frame_base=None) -> dict:
    """Advance carried beam state over one chunk of logits.

    The frames processed are exactly the prefix-beam recurrence: N chunks
    through this function equal one ctc_beam_search_torch call over the
    concatenated valid frames.

    Args:
        state: a beam_state_init dict on the logits' device.
        logits: (batch, T_chunk, vocab), unnormalised.
        valid: an int or (batch,) ints (a tensor, array or list): frames
            [0, valid) of each row are real; the rest leave every leaf of
            that row untouched (the padding chunks of shorter utterances
            in a batched stream group).
        frame_base: optional, an int or (batch,) ints: each row's absolute
            output frame of this chunk's first frame; the recorded spans
            are absolute. Defaults to 0.
    """
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    batch, t_chunk, _ = lp.shape
    device = lp.device
    valid = torch.as_tensor(valid, dtype=torch.int32).broadcast_to((batch,))
    steps = min(t_chunk, int(valid.max())) if batch else 0
    valid = valid.to(device)
    base = torch.as_tensor(0 if frame_base is None else frame_base,
                           dtype=torch.int32).broadcast_to((batch,)).to(device)
    leaves = [state[key] for key in _RESUME_KEYS]
    # frames past every row's valid count change nothing: not stepped
    for t in range(steps):
        beams, track, overflow = tuple(leaves[:6]), tuple(leaves[6:13]), leaves[13]
        new, dropped, new_track = _beam_frame_step(beams, lp[:, t], blank_token,
                                                   t=base + t, track=track)
        active = valid > t
        leaves = [torch.where(active.reshape((batch,) + (1,) * (o.dim() - 1)), n, o)
                  for n, o in zip(new + new_track, beams + track)]
        leaves.append(overflow | (active & dropped))
    return dict(zip(_RESUME_KEYS, leaves))


@torch.inference_mode()
def beam_commit(state: dict) -> Tuple[dict, torch.Tensor, dict]:
    """Emit the longest common prefix of the live beams and shift it out.

    Every future hypothesis descends from the current beams, so tokens
    every live beam shares are final: a live stream emits them at once,
    and shifting them out of the prefix buffer keeps a long session's
    state bounded.

    Returns (new_state, ncommit (batch,), info): info holds the committed
    data of the best beam (which every live beam agrees with on the
    committed span): "tokens", "starts", "ends", "lp_sum", "lp_n" each
    (batch, cap) with the first ncommit entries meaningful, and
    "tail_end", "tail_lp", "tail_n" (batch,): frames since the last
    commit that extended the previously committed token's run (the
    tails reset on every commit).
    """
    prefixes, lengths, scores = state["prefixes"], state["lengths"], state["scores"]
    batch, k, cap = prefixes.shape
    device = prefixes.device
    live = scores > NEG_INF / 2
    ref = prefixes[:, 0]  # rows are sorted best first; row 0 is live
    minlen = torch.where(live, lengths, torch.full_like(lengths, cap + 1)).amin(dim=1)
    eq = (prefixes == ref[:, None, :]) | ~live[:, :, None]
    pos = torch.arange(cap, dtype=torch.int32, device=device)
    col_ok = eq.all(dim=1) & (pos[None, :] < minlen[:, None])
    c = torch.cumprod(col_ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    src = (c[:, None] + pos[None, :]).to(torch.int64)[:, None, :].expand(batch, k, cap)

    def shift(buf, fill):
        padded = torch.cat([buf, torch.full_like(buf, fill)], dim=2)
        return torch.gather(padded, 2, src)

    new_state = dict(state)
    new_state["prefixes"] = shift(prefixes, -1)
    new_state["lengths"] = torch.clamp(lengths - c[:, None], min=0)
    for key in ("starts", "ends", "lp_sum", "lp_n"):
        new_state[key] = shift(state[key], 0)
    for key in ("tail_end", "tail_lp", "tail_n"):
        new_state[key] = torch.zeros_like(state[key])
    info = {"tokens": ref}
    for key in ("starts", "ends", "lp_sum", "lp_n", "tail_end", "tail_lp", "tail_n"):
        info[key] = state[key][:, 0]
    return new_state, c, info


def _host(state: dict, keys) -> dict:
    return {key: state[key].cpu().numpy() for key in keys}


def beam_finalize(state: dict):
    """Final beams on the host: per item, a list of (tokens, score) pairs
    for every live beam, best acoustic score first, and the (batch,)
    overflow flags. Tokens are the uncommitted suffixes if beam_commit
    was used: the caller prepends its committed history."""
    h = _host(state, ("prefixes", "lengths", "scores", "overflow"))
    prefixes, lengths, scores = h["prefixes"], h["lengths"], h["scores"]
    out = []
    for b in range(prefixes.shape[0]):
        out.append([(prefixes[b, i, : lengths[b, i]].tolist(), float(scores[b, i]))
                    for i in range(prefixes.shape[1]) if scores[b, i] > NEG_INF / 2])
    return out, h["overflow"]


def beam_finalize_full(state: dict):
    """beam_finalize with each beam's suffix frame spans and token log
    posteriors: per item, a list of dicts {"tokens", "score", "stamps"
    [(start, end), ...], "lp" [[lp_sum, n_frames], ...]} for every live
    beam (best first), and the (batch,) overflow flags. Spans are
    absolute output frames (the frame_base given to ctc_beam_resume)."""
    h = _host(state, ("prefixes", "lengths", "scores", "starts", "ends", "lp_sum", "lp_n",
                      "overflow"))
    out = []
    for b in range(h["prefixes"].shape[0]):
        beams = []
        for i in range(h["prefixes"].shape[1]):
            if h["scores"][b, i] <= NEG_INF / 2:
                continue
            n = h["lengths"][b, i]
            beams.append({
                "tokens": h["prefixes"][b, i, :n].tolist(),
                "score": float(h["scores"][b, i]),
                "stamps": [(int(s), int(e))
                           for s, e in zip(h["starts"][b, i, :n], h["ends"][b, i, :n])],
                "lp": [[float(s), int(c)]
                       for s, c in zip(h["lp_sum"][b, i, :n], h["lp_n"][b, i, :n])],
            })
        out.append(beams)
    return out, h["overflow"]


class StreamingBeam:
    """Chunk-carried beam search for `batch` independent streams.

    Wraps beam_state_init / ctc_beam_resume / beam_commit / beam_finalize
    with the host's committed-token bookkeeping and optional n-best
    rescoring at finalize (LM shallow fusion, hot-word boosting: the
    rescoring of the offline device backend, decode.CTCDecoder).

    update() keeps everything on the device (the chunk's logits go from
    the model's step into the beam without a host round trip); commit()
    costs one small transfer and yields the newly final tokens per
    stream (the common prefix of every live beam: monotone, never
    retracted); finalize() returns each stream's best full token
    sequence, rescored if scorers were given.
    """

    def __init__(self, batch: int, beam_width: int, cap: int = 256, blank_token: int = 0,
                 scorers=None, device="cpu"):
        self.batch = batch
        self.beam_width = beam_width
        self.cap = cap
        self.blank_token = blank_token
        # [(scorer, weight)]: a scorer exposes total_score(tokens) or
        # score(tokens) for whole-sequence scoring
        self.scorers = scorers or []
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self.committed: List[List[int]] = [[] for _ in range(self.batch)]
        self._state = beam_state_init(self.batch, self.beam_width, self.cap, self.device)
        self.overflowed = False

    def update(self, logits: torch.Tensor, valid, frame_base=0) -> None:
        """Advance over one chunk. logits (batch, T_chunk, vocab) on the
        device; valid: an int or (batch,) ints, frames beyond it are
        padding; frame_base (an int or (batch,)): the absolute output frame
        of the chunk's first frame, for the span tracks."""
        self._state = ctc_beam_resume(self._state, logits, np.asarray(valid, np.int32),
                                      self.blank_token,
                                      frame_base=np.asarray(frame_base, np.int32))

    def commit(self) -> List[dict]:
        """Emit the newly final tokens per stream (appended to
        self.committed) and shift them out of the device buffers.

        Returns one dict per stream: "tokens" (the newly committed ids),
        "stamps" [(start, end) absolute output frames], "lp" [[lp_sum,
        n_frames]] per token, and "tail" (end, lp_sum, n): frames since
        the last commit that extended the previously committed token's
        run (None if none)."""
        self._state, nc, info = beam_commit(self._state)
        nc = nc.cpu().numpy()
        info = {key: v.cpu().numpy() for key, v in info.items()}
        out = [commit_row(nc, info, b) for b in range(self.batch)]
        for b, row in enumerate(out):
            self.committed[b].extend(row["tokens"])
        return out

    def finalize(self) -> List[List[int]]:
        """The best full token sequence per stream: the committed prefix
        and the best live beam's suffix, ranked by acoustic score plus any
        configured rescorers over the full sequence."""
        beams, overflow = beam_finalize(self._state)
        self.overflowed |= bool(np.asarray(overflow).any())
        return [rescore_pick_best(self.committed[b], beams[b], self.scorers)
                for b in range(self.batch)]

    def finalize_full(self) -> List[dict]:
        """finalize() with the chosen beam's suffix frame spans: one dict
        per stream {"tokens" (the full sequence), "suffix_stamps",
        "suffix_lp"}; the suffix fields align with the tokens after the
        committed prefix (the caller holds the committed spans from its
        commit() calls)."""
        beams_full, overflow = beam_finalize_full(self._state)
        self.overflowed |= bool(np.asarray(overflow).any())
        return [finalize_pick(self.committed[b], beams_full[b], self.scorers)
                for b in range(self.batch)]


def commit_row(nc: np.ndarray, info: dict, b: int) -> dict:
    """Row b of a beam_commit's (ncommit, info), both on the host: its
    newly committed "tokens", their "stamps" [(start, end)] and "lp"
    [[lp_sum, n_frames]], and the "tail" (end, lp_sum, n) that extended
    the previously committed token's run (None if none)."""
    n = nc[b]
    tail = None
    if info["tail_n"][b] > 0:
        tail = (int(info["tail_end"][b]), float(info["tail_lp"][b]), int(info["tail_n"][b]))
    return {
        "tokens": info["tokens"][b, :n].tolist(),
        "stamps": [(int(s), int(e)) for s, e in zip(info["starts"][b, :n], info["ends"][b, :n])],
        "lp": [[float(s), int(c)] for s, c in zip(info["lp_sum"][b, :n], info["lp_n"][b, :n])],
        "tail": tail,
    }


def rescore_pick_best(committed, beams, scorers, return_index: bool = False):
    """Pick one stream's best full token sequence at finalize.

    `committed` is the already-final prefix, `beams` the live (suffix
    tokens, acoustic score) n-best, `scorers` [(scorer, weight)] pairs
    applied to the full sequence (LM shallow fusion, hot-word boosting).
    return_index=True also returns the chosen beam's index into `beams`
    (None if `beams` is empty), so the caller can take its spans."""
    cands = [(i, list(committed) + suffix, ac) for i, (suffix, ac) in enumerate(beams)] \
        or [(None, list(committed), 0.0)]
    if scorers:
        def total(cand):
            _, toks, acoustic = cand
            t = acoustic
            for scorer, weight in scorers:
                fn = getattr(scorer, "total_score", None) or scorer.score
                t += weight * fn(toks)
            return t

        best = max(cands, key=total)
    else:
        best = max(cands, key=lambda p: p[2])
    if return_index:
        return best[1], best[0]
    return best[1]


def finalize_pick(committed, beams_full, scorers) -> dict:
    """rescore_pick_best over beam_finalize_full entries: {"tokens" (the
    full sequence, committed prefix included), "suffix_stamps",
    "suffix_lp"} of the chosen hypothesis (empty span lists when no live
    beam exists)."""
    pairs = [(d["tokens"], d["score"]) for d in beams_full]
    tokens, idx = rescore_pick_best(committed, pairs, scorers, return_index=True)
    if idx is None:
        return {"tokens": tokens, "suffix_stamps": [], "suffix_lp": []}
    return {"tokens": tokens, "suffix_stamps": beams_full[idx]["stamps"],
            "suffix_lp": beams_full[idx]["lp"]}


def beams_to_token_lists(tokens, lengths) -> List[List[List[int]]]:
    """(batch, k, T) padded buffers -> nested Python token lists."""
    tokens, lengths = np.asarray(tokens), np.asarray(lengths)
    return [[tokens[b, i, : lengths[b, i]].tolist() for i in range(tokens.shape[1])]
            for b in range(tokens.shape[0])]
