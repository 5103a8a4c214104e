"""A profiled slice of a run: the device's operations and the host's spans
from a ``torch.profiler`` window (CPU and CUDA activities), reduced to
intervals the metric readers and the breakdown read.

The harness opens a span ``portbench.slice`` around the profiled calls and
one ``portbench.call`` around each call; the slice's span is the window.
Device operations are kernels, copies and sets; a gap is a stretch of the
window that no device interval covers, labelled by the innermost host
span or operator open on the harness's thread at the gap's midpoint.
"""

from __future__ import annotations

import json
import os
import re
import resource
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SLICE = "portbench.slice"
CALL = "portbench.call"


@dataclass
class Trace:
    """What a profiled slice saw. Times in seconds, relative to the slice.

    kind: the entry's kind ("offline", "train"); model: the configuration's
    keys; calls: the slice's calls as the harness made them (each a dict
    with "frames" and "rows", the valid samples of each row); window_s:
    the slice's wall length; device: [(name, start, end)] in the window."""

    kind: str
    model: dict
    calls: List[dict]
    window_s: float
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    host_system_s: Optional[float] = None  # the process's system (kernel) CPU time over the slice
    host_wall_s: Optional[float] = None    # ... and the wall time it was taken over

    def kernels(self, pattern: str) -> List[Tuple[str, float, float]]:
        rx = re.compile(pattern)
        return [e for e in self.device if rx.search(e[0])]

    def busy_s(self) -> float:
        """The union of the device intervals."""
        busy, reach = 0.0, 0.0
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            if end <= reach:
                continue
            busy += end - max(start, reach)
            reach = end
        return busy

    def idle_share(self) -> Optional[float]:
        """The share (%) of the window no device interval covers."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s) if self.window_s > 0 else None

    def host_system_share(self) -> Optional[float]:
        """The share (%) of the slice's wall time the process spent in the
        host's kernel (page faults and the zeroing of fresh pages, system
        calls), by its own CPU-time counter."""
        if self.host_system_s is None or not self.host_wall_s:
            return None
        return 100.0 * self.host_system_s / self.host_wall_s

    def ops_per_call(self) -> Optional[float]:
        """Device kernels, copies and sets per call of the slice."""
        return len(self.device) / len(self.calls) if self.calls else None

    def gaps(self) -> List[Tuple[float, float]]:
        """The stretches of the window no device interval covers."""
        out, reach = [], 0.0
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            if start > reach:
                out.append((reach, start))
            reach = max(reach, end)
        if reach < self.window_s:
            out.append((reach, self.window_s))
        return out

    def gap_labels(self) -> Dict[str, float]:
        """Idle seconds by the innermost host span open at each gap's
        midpoint ("(no host span)" where none is). The spans of one thread
        nest, so one sweep with a stack finds each."""
        host = sorted(self.host, key=lambda e: (e[1], -e[2]))
        out: Dict[str, float] = {}
        stack: List[Tuple[str, float, float]] = []
        i = 0
        for lo, hi in sorted(self.gaps()):
            mid = 0.5 * (lo + hi)
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] <= host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            label = stack[-1][0] if stack else "(no host span)"
            out[label] = out.get(label, 0.0) + (hi - lo)
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = {}
        for name, start, end in self.device:
            key = name[:160]
            by_op[key] = by_op.get(key, 0.0) + (end - start)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gap_labels().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def host_system(usage, since: float) -> Tuple[float, float]:
    """(system CPU seconds, wall seconds) of this process from ``usage``
    (a ``resource.getrusage`` reading) and ``since`` (``perf_counter``) on."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    return now.ru_stime - usage.ru_stime, time.perf_counter() - since


def start():
    """An open profiler over the CPU and CUDA activities."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def reduce(prof, kind: str, model: dict, calls: List[dict]) -> Optional[Trace]:
    """The Trace of a stopped profiler; None if the slice's span is
    missing. The chrome trace goes through a temporary file that is
    deleted at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, kind, model, calls)


def reduce_events(events: List[dict], kind: str, model: dict,
                  calls: List[dict]) -> Optional[Trace]:
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SLICE
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    sl = spans[0]
    t0, t1 = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
    tid = sl.get("tid")
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end <= t0 or start >= t1:
            continue
        cat = e.get("cat", "")
        span = (e["name"], (max(start, t0) - t0) * 1e-6, (min(end, t1) - t0) * 1e-6)
        if cat in DEVICE_CATS:
            device.append(span)
        elif cat in HOST_CATS and e.get("tid") == tid and e["name"] != SLICE:
            host.append(span)
    return Trace(kind, model, calls, (t1 - t0) * 1e-6, device, host)
