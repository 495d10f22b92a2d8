"""The traced run: the benchmark's own spans around each dynamic, the
profiler's device trace, and what the per-layer readers take from them.

Spans: ``install_spans`` wraps each step function of the particulator's
composed step (``Particulator._named_step_fns``: one a dynamic, then the
commits) in a ``torch.profiler.record_function`` scope named
``portbench/<dynamic>``, and composes the step again. The scopes add no
synchronise. A device operation belongs to the span in which the host
launched it: the profiler links each kernel, copy and fill to its launch
call by a correlation id, and the launch call lies inside one span.

The busy time is the length of the union of the device operations'
intervals (the arithmetic of ``tools/profile_torch_box.py`` ``busy_us``,
copied here).
"""

import bisect
import collections
import dataclasses
import json
import os
import tempfile
import time

import torch

SPAN_PREFIX = "portbench/"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


def install_spans(particulator):
    """every step function of the composed step under a span of its name"""

    def spanned(label, fn):
        def step(sim):
            with torch.profiler.record_function(label):
                return fn(sim)

        return step

    particulator._named_step_fns = tuple(
        (name, spanned(SPAN_PREFIX + name, fn))
        for name, fn in particulator._named_step_fns
    )
    particulator._compose()


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    category: str
    start_us: float
    dur_us: float
    span: str  # the dynamic it was launched in, or None


@dataclasses.dataclass
class Trace:
    """what a per-layer reader reads: the traced episodes' device operations
    with their spans, the window, and the cell's counts and shapes"""

    ops: list
    window_s: float
    busy_s: float
    steps: int
    host_reads: int
    shapes: dict

    def kernels(self, pattern, span=None):
        """the kernels whose name holds ``pattern`` (and that were launched
        in ``span``, if given)"""
        return [
            op for op in self.ops
            if op.category == "kernel" and pattern in op.name
            and (span is None or op.span == span)
        ]

    def span_device_s(self, span):
        """device seconds of the operations launched in ``span``"""
        return sum(op.dur_us for op in self.ops if op.span == span) * 1e-6

    def spans(self):
        return {op.span for op in self.ops if op.span is not None}


def busy_us(intervals):
    """length of the union of the (start, end) intervals"""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_episode(run, synchronize):
    """``run()`` under the profiler, from an idle device to a wait for it
    (``synchronize()``); returns (the trace's events, the host seconds of
    the stretch)"""
    from torch.profiler import ProfilerActivity, profile

    synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    run()
    synchronize()
    window_s = time.perf_counter() - t0
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events, window_s


def _spans(events):
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):])
        for e in events
        if e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(SPAN_PREFIX) and "dur" in e
    )
    return spans, [s[0] for s in spans]


def _span_at(spans, starts, ts):
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and ts <= spans[i][1]:
        return spans[i][2]
    return None


def device_ops(events):
    """the device operations, each with the span its launch call lies in"""
    launch_ts = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    spans, starts = _spans(events)
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES or "dur" not in e:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        span = None if ts is None else _span_at(spans, starts, ts)
        ops.append(DeviceOp(e["name"], e["cat"], float(e["ts"]), float(e["dur"]), span))
    return ops


def idle_gaps(events, ops):
    """the device's idle gaps inside the traced stretch, summed by what the
    host was doing in each (the span and the innermost host call covering
    the gap's middle), longest first: [[name, seconds], ...]"""
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES and "dur" in e]
    if not host or not ops:
        return []
    # the thread that launched most: the one the step runs on
    tid = collections.Counter(e.get("tid") for e in host).most_common(1)[0][0]
    host = sorted(
        ((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
         if e.get("tid") == tid),
        key=lambda x: (x[0], -x[1]),
    )
    busy = merged((op.start_us, op.start_us + op.dur_us) for op in ops)
    gaps = [(host[0][0], busy[0][0])] if host[0][0] < busy[0][0] else []
    gaps += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    spans, starts = _spans(events)
    by_name = collections.defaultdict(float)
    stack, j = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        call = stack[-1][2] if stack else "(no host call)"
        span = _span_at(spans, starts, mid) or "-"
        by_name[f"{span}/{call}"] += (b - a) * 1e-6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP]


def top_device_ops(ops):
    """the device operations that took most time, summed by name:
    [[name, seconds], ...]"""
    by_name = collections.defaultdict(float)
    for op in ops:
        by_name[op.name] += op.dur_us * 1e-6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP]
