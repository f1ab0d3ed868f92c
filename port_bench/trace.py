"""One profiled stretch of a run, reduced to what the per-layer readers take.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` with the device's activity
alone (CUPTI's records of kernels, copies and sets, which cost the host little)
and ends in ``synchronize()``; the call is the traced window. From the trace:
every device operation's interval, their union (the device's busy time) and
device time by operation name. ``profile(fn, host=True)`` records the host's
operations too, inside a named range that is the window; they cost the host
microseconds each, so such a stretch only names the idle gaps: each by the
innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "port_bench.window"


def profile(fn: Callable[[], object], host: bool = False) -> Dict:
    cuda = torch.cuda.is_available()
    activities = []
    if host or not cuda:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    named = torch.profiler.record_function(WINDOW) if host else contextlib.nullcontext()
    with torch.profiler.profile(activities=activities) as prof:
        with named:
            start = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            host_s = time.perf_counter() - start
    return reduce_events(prof.events(), host_s)


def _is_device(event) -> bool:
    """An operation that ran on the card: a kernel, a copy or a set; not the
    device-side copy of a host range (``record_function``'s annotations)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def reduce_events(events, host_s: float) -> Dict:
    """Device intervals within the window and what follows from them; a device
    event named as a host range is that range's annotation and is left out.
    Without the host's named range the window is the call's ``host_s`` from the
    first device operation's start: every operation was launched within the call,
    after its opening ``synchronize()``, and ended before its closing one."""
    host_names = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    events = [e for e in events if not (_is_device(e) and e.name in host_names)]
    window = [e for e in events
              if e.name == WINDOW and e.device_type != torch.autograd.DeviceType.CUDA]
    device = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in events if _is_device(e)), key=lambda x: x[0])
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA and e.name != WINDOW]
    if window:
        w0, w1 = window[0].time_range.start, window[0].time_range.end
    elif device:
        w0, w1 = device[0][0], device[0][0] + host_s * 1e6
    else:
        w0, w1 = 0.0, host_s * 1e6
    busy, merged = 0.0, []
    for start, end, _ in device:
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy = sum(end - start for start, end in merged)
    gaps = []
    edges = [w0] + [x for pair in merged for x in pair] + [w1]
    for start, end in zip(edges[0::2], edges[1::2]):
        if end > start:
            gaps.append((start, end))
    by_name: Dict[str, float] = collections.Counter()
    for start, end, name in device:
        by_name[name] += max(0.0, min(end, w1) - max(start, w0)) / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "device": [(s / 1e6, e / 1e6, n) for s, e, n in device],
        "by_name": dict(by_name),
        "gaps": [(s / 1e6, e / 1e6) for s, e in gaps],
        "host": host,
    }


def device_ops(trace: Dict, top: int = 10) -> List[Tuple[str, float]]:
    ranked = sorted(trace["by_name"].items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], seconds] for name, seconds in ranked]


def idle_gaps(trace: Dict, top: int = 10) -> List[Tuple[str, float]]:
    """The idle time summed by the host operation at each gap's middle: the one
    that began last among those still running there (the innermost, where host
    operations nest), searched among the 256 that began last before it."""
    host = sorted(trace["host"], key=lambda h: h[0])
    starts = [h[0] for h in host]
    totals: Dict[str, float] = collections.Counter()
    for start, end in trace["gaps"]:
        mid = (start + end) / 2 * 1e6
        name = "(no host operation)"
        at = bisect.bisect_right(starts, mid)
        for h in reversed(host[max(0, at - 256): at]):
            if h[1] >= mid:
                name = h[2]
                break
        totals[name] += end - start
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:160], seconds] for name, seconds in ranked]


def kernel_seconds(trace: Dict, *fragments: str) -> float:
    """Device seconds of the operations whose names hold any of ``fragments``."""
    return sum(s for name, s in trace["by_name"].items() if any(f in name for f in fragments))
