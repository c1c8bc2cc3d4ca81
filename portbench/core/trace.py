"""A bounded traced slice: the device's operations and idle time.

``traced(run, replays)`` profiles ``run()`` under ``torch.profiler`` with
the CUDA activity alone: CUPTI's records of the device's operations and of
the CUDA runtime calls that launched them.  The CPU activity, a record of
every host operation, is left off: it slows the host, and with it the
feed of a card that waits on the host, so an idle share read under it is
the profiler's as much as the program's.

With ``replays = (skip, record)`` the profiler follows the CUDA graphs'
replays (``torch.cuda.CUDAGraph.replay``) instead of the calls: replays
``skip`` to ``skip + record - 1`` of ``run()`` are recorded, each with the
host's work up to the next replay, after one replay in which the profiler
warms up unrecorded.  So a slice of a long graph solve is taken away from
its head, and a solve too long to trace whole is traced in part.

The slice is measured over the trace's own span, from its first record
(a runtime call or a device operation) to the end of its last device
operation:

* ``busy_s``: the union of the device operations' intervals in the span;
* ``window_s``: the span's length, less the device's idle gaps that the
  profiler's own host work holds (``PROFILER_OPS``: its buffer flushes
  and requests, where it records them), which no untraced run has;
* ``device_ops``: device seconds by operation name, the largest first;
* ``idle_gaps``: the device's idle gaps, each named by the CUDA runtime
  call the host was in at its middle (``cudaStreamSynchronize``: waiting
  on the card; ``cudaMemcpyAsync``: a copy; ``HOST_ONLY``: in none, the
  host's own work between calls), seconds by name, the largest first.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

# host work of the profiler itself (Kineto's buffer handling)
PROFILER_OPS = ("Buffer Flush", "Activity Buffer Request")
# the label of a gap in which the host was in no CUDA runtime call
HOST_ONLY = "(host, no CUDA call)"
# host records that mark the profiler's steps, not the host's work
_STEP = "ProfilerStep"
_NAME_CHARS = 160


class Trace(NamedTuple):
    kernels: list     # (name, start_us, end_us) of every device operation
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds], ...], largest first
    idle_gaps: list   # [[host call, seconds], ...], largest first


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(kernels, host, top=10) -> Trace:
    """The trace's figures from the device operations and the host's
    records (the CUDA runtime calls), each a list of ``(name, start_us,
    end_us)``."""
    if not kernels:
        raise ValueError("the trace holds no device operation")
    host = [h for h in host if not h[0].startswith(_STEP)]
    lo = min([s for _, s, _ in kernels] + [s for _, s, _ in host])
    hi = max(e for _, _, e in kernels)
    busy = _merged([(s, e) for _, s, e in kernels])
    busy_us = sum(b - a for a, b in busy)

    by_name = defaultdict(float)
    for n, s, e in kernels:
        by_name[n[:_NAME_CHARS]] += (e - s) * 1e-6
    device_ops = sorted(([k, v] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:top]

    calls = sorted((s, e, n) for n, s, e in host)
    starts = [c[0] for c in calls]
    gaps = defaultdict(float)
    edges = [lo] + [t for ab in busy for t in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = HOST_ONLY
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 256), -1):
            if calls[j][1] >= mid:
                label = calls[j][2][:_NAME_CHARS]
                break
        gaps[label] += (b - a) * 1e-6
    idle_gaps = sorted(([k, v] for k, v in gaps.items()),
                       key=lambda kv: -kv[1])[:top]
    own = sum(gaps.get(name, 0.0) for name in PROFILER_OPS)
    return Trace(kernels, (hi - lo) * 1e-6 - own, busy_us * 1e-6,
                 device_ops, idle_gaps)


def traced(run, replays=None):
    """``(run(), Trace)`` with ``run`` profiled on the card: whole, or
    with ``replays = (skip, record)`` the graph replays ``skip`` to
    ``skip + record - 1`` of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    saved = []
    kw = {}
    if replays:
        skip, record = (int(v) for v in replays)
        if skip < 1 or record < 1:
            raise ValueError(f"replays {replays}: skip and record must be "
                             "at least 1")
        # replay j runs after the profiler's (j + 1)-th step: replay
        # skip - 1 warms it up, replays skip .. skip + record - 1 record
        kw = {"schedule": schedule(wait=skip, warmup=1, active=record,
                                   repeat=1),
              "on_trace_ready": lambda p: saved.append(list(p.events()))}
    graph = torch.cuda.CUDAGraph
    original = graph.replay
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], **kw) as prof:
        if replays:
            def replay(self, *a, **k):
                prof.step()
                return original(self, *a, **k)

            graph.replay = replay
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            graph.replay = original
    if not replays:
        events = prof.events()
    elif saved:
        events = saved[0]
    else:
        raise ValueError(f"the traced calls made no more than {skip} graph "
                         "replays: nothing was recorded")
    kernels, host = [], []
    for e in events:
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not getattr(e, "is_user_annotation", False):
            # an annotation's range on the device's timeline is no operation
            kernels.append(row)
    return out, summarize(kernels, host)


def device_seconds(trace: Trace, part: str) -> tuple:
    """``(seconds, operations)`` of the device operations whose name holds
    ``part``."""
    hits = [(e - s) * 1e-6 for n, s, e in trace.kernels if part in n]
    return sum(hits), len(hits)
