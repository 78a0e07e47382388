"""The card's activity over a window, from CUDA activity records.

`Capture` wraps torch.profiler: with trace=False it records the card's
activity alone (kernels, copies, memsets: no CPU operations, no ranges),
with trace=True also the host's operations and the harness's ranges.
The harness marks the start of every call with two marker kernels
(`torch.cuda._sleep(0)`, a `spin_kernel` that nothing else launches);
the calls are synchronous, so the card's activity between two calls'
markers is the first call's.  Every time here is the card's own record;
the host clock is never read.

The arithmetic (interval union, per-call split, idle gaps by host range)
is plain Python over (start_ns, end_ns) pairs, so the tests hold it on
made-up records.
"""

from __future__ import annotations

import bisect
import heapq

MARKER = "spin_kernel"
BUSY_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
COPY_KINDS = ("gpu_memcpy",)
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the harness's own record_function ranges (--trace 1), which the profiler
# also mirrors onto the card's timeline
RANGE_PREFIXES = ("harness.", "decoder.", "encoder.")


def kind_of(e, on_card: bool) -> str:
    """The activity kind of a kineto event: its own where the profiler
    reports it (activity_type), else from the card's naming of copies and
    memsets ("Memcpy ...", "Memset ..."); a range of the harness mirrored
    onto the card is an annotation, not work."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    ann = getattr(e, "is_user_annotation", None)
    name = e.name()
    if on_card:
        if (ann is not None and ann()) or name.startswith(RANGE_PREFIXES):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if ann is not None and ann() else "cpu_op"


def union(intervals):
    """Merged, sorted, non-overlapping [(start, end)] of intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def total(intervals) -> int:
    """Length of the union of intervals."""
    return sum(e - s for s, e in union(intervals))


def per_call(intervals, marks):
    """Busy length of each call: the union of `intervals` split at the
    sorted call starts `marks` (call k owns [marks[k], marks[k+1]), the
    last one all that follows; anything before the first mark is the
    first call's)."""
    out = [0] * len(marks)
    for s, e in union(intervals):
        k = max(bisect.bisect_right(marks, s) - 1, 0)
        while s < e and k < len(marks):
            cut = min(e, marks[k + 1]) if k + 1 < len(marks) else e
            out[k] += max(cut - s, 0)
            s = max(s, cut)
            k += 1
    return out


def call_starts(card):
    """The start of each call: the first of each run of marker records
    with no work between them.  The harness launches two markers before
    every call, so a call keeps its start where the profiler loses one
    record (it has been seen to, once in some hundred calls)."""
    out, in_run = [], False
    for s, _, _, n in sorted(card):
        if MARKER in n:
            if not in_run:
                out.append(s)
            in_run = True
        else:
            in_run = False
    return out


def gaps(intervals, start, end):
    """The idle [(start, end)] between the union of intervals inside
    [start, end]."""
    out, t = [], start
    for s, e in union(intervals):
        if e <= start or s >= end:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out


def idle_by_range(idle, ranges, outside="host_outside_any_range"):
    """Idle time by what the host was doing: each stretch of the idle
    intervals goes to the innermost of `ranges` [(start, end, name)] open
    over it (the latest-starting one), or to `outside`.  Returns {name:
    time}."""
    idle = sorted(idle)
    bounds = sorted([(s, 1, i) for i, (s, _, _) in enumerate(ranges)]
                    + [(e, 0, i) for i, (_, e, _) in enumerate(ranges)])
    out, heap, ended = {}, [], set()
    g, prev = 0, None

    def charge(lo, hi, name):
        nonlocal g
        while g < len(idle) and idle[g][1] <= lo:
            g += 1
        j = g
        while j < len(idle) and idle[j][0] < hi:
            cut = min(hi, idle[j][1]) - max(lo, idle[j][0])
            if cut > 0:
                out[name] = out.get(name, 0) + cut
            j += 1

    lo = idle[0][0] if idle else 0
    for t, is_start, i in bounds:
        while heap and heap[0][1] in ended:
            heapq.heappop(heap)
        seg = lo if prev is None else prev
        if t > seg:
            charge(seg, t, ranges[heap[0][1]][2] if heap else outside)
        prev = max(t, seg)
        if is_start:
            heapq.heappush(heap, (-ranges[i][0], i))
        else:
            ended.add(i)
    if idle:
        seg = lo if prev is None else prev
        charge(seg, max(seg, idle[-1][1]), outside)
    return out


def top(d: dict, n: int = 10):
    return sorted(d.items(), key=lambda kv: -kv[1])[:n]


class Capture:
    """torch.profiler over a window; records() gives the card's activity
    and, with trace=True, the host's ranges."""

    def __init__(self, trace: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA]
        if trace:
            acts.insert(0, ProfilerActivity.CPU)
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def records(self):
        """(card, host): card = [(start_ns, end_ns, kind, name)] of
        kernels, copies and memsets, markers included; host = [(start_ns,
        end_ns, name)] of the host's operations and ranges (empty unless
        trace)."""
        import torch

        cuda = torch._C._autograd.DeviceType.CUDA
        card, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            on_card = e.device_type() == cuda
            kind = kind_of(e, on_card)
            s = e.start_ns()
            rec = (s, s + e.duration_ns())
            if on_card:
                if kind in BUSY_KINDS:
                    card.append((*rec, kind, e.name()))
            elif kind in HOST_KINDS:
                host.append((*rec, e.name()))
        return card, host


def summarize(card, host=()):
    """The window's numbers from Capture.records(), which hold the window
    alone: the call starts, busy (the union of everything but markers),
    copy (the union of host<->device copies), stage (the union of the
    rest), the busy time of each call, the top device operations and
    (with host ranges) idle time by host range.  Times in ns."""
    marks = call_starts(card)
    work = [(s, e, k, n) for s, e, k, n in card if MARKER not in n]
    iv = [(s, e) for s, e, _, _ in work]

    def is_copy(k, n):
        return k in COPY_KINDS and ("HtoD" in n or "DtoH" in n)

    ops: dict = {}
    for s, e, _, n in work:
        ops[n] = ops.get(n, 0) + (e - s)
    out = {
        "busy": total(iv),
        "copy": total([(s, e) for s, e, k, n in work if is_copy(k, n)]),
        "stage": total([(s, e) for s, e, k, n in work if not is_copy(k, n)]),
        "calls": per_call(iv, marks),
        "device_ops": top(ops),
    }
    if host and marks:
        idle = gaps(iv, marks[0], max([e for _, e in iv] + marks[-1:]))
        out["idle_gaps"] = top(idle_by_range(idle, host))
    return out
