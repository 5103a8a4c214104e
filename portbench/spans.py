"""The program's own host spans (``velocity_asr_tpu_torch.tracing``) in a
profiled slice: the time named spans cover on the calling thread, per
call of the slice."""

from __future__ import annotations

from typing import Iterable, Optional


def per_call_ms(trace, kind: str, names: Iterable[str]) -> Optional[float]:
    """Milliseconds a call that the spans named in `names` cover on the
    calling thread, summed over the slice and divided by its calls. A
    span inside another of `names` counts once. None for another kind,
    or where a name appears fewer times than the slice has calls (a
    program without these spans)."""
    names = set(names)
    if trace.kind != kind or not trace.calls:
        return None
    hits = [(start, end) for name, start, end in trace.host if name in names]
    seen = {name: 0 for name in names}
    for name, _, _ in trace.host:
        if name in seen:
            seen[name] += 1
    if min(seen.values()) < len(trace.calls):
        return None
    covered, reach = 0.0, float("-inf")
    for start, end in sorted(hits):
        if end <= reach:
            continue
        covered += end - max(start, reach)
        reach = end
    return 1e3 * covered / len(trace.calls)
