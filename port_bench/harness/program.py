"""The program's own recording (tungsten_tpu_torch/utils/trace.py) read
against a profiled frame: the readers of the per-layer metrics that rest on
the program's spans and counters, and the profile they need. `anchor` and
`attribute` put the recording onto the device trace's clock: a marker
launch bracketed by two host clock reads gives the offset between the
clocks, and each kernel goes to the innermost span open when its launch
record was made.

A record `rec` for these readers holds `program` (the Recording, open from
the scene's load to the window's end, its walk counters counted over the
window alone), `prof` (what `profiled()` filled: the device events as
trace.profiled gives them, their correlation ids, the launch records and
the clock anchor), `window_ns` (the window on the host clock), `n_frames`
and `lanes0` (walk.lanes when the window opened). A reader returns None
where the run recorded nothing for it. program_trace.py runs a cell with
them; run.py does not open the recorder yet (PERF.md, open questions).
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch

from . import trace

MARKERS = 8  # marker launches bracketed for the clock anchor; the tightest is kept
INTEGRATOR = {"pt": ("pt.batch",), "sppm": ("sppm.photons", "sppm.grid", "sppm.gather")}


def anchor(brackets) -> tuple:
    """(offset, error) ns from marker launches: each bracket (h0, h1, r0, r1)
    holds the host clock read before and after one launch (h0, h1) and the
    launch's record on the trace clock (r0, r1). trace = host + offset,
    within error (half the bracket the record leaves); the tightest bracket
    is taken."""
    best = None
    for h0, h1, r0, r1 in brackets:  # whole ns: the trace clock counts from 1970
        err = max((h1 - h0) - (r1 - r0), 0) / 2
        if best is None or err < best[1]:
            best = ((r0 + r1 - h0 - h1) // 2, err)
    if best is None:
        raise ValueError("anchor: no marker launch")
    return best


def attribute(kernels, launches: dict, spans, offset: float) -> dict:
    """Device time by span: each kernel (start, end, name, correlation id)
    goes to the innermost span open on the host when its launch record
    (`launches`: correlation id -> the record's start, trace clock) was
    made; -1 takes the kernels launched outside every span or without a
    record. spans: a Recording's [name, start, end, parent] (host clock);
    offset: trace = host + offset. -> {span index or -1: ns}; every kernel
    is counted once."""
    starts = sorted(range(len(spans)), key=lambda i: spans[i][1])
    keys = [spans[i][1] for i in starts]
    out: dict = {}
    for a, b, _, corr in kernels:
        owner = -1
        t = launches.get(corr)
        if t is not None:
            h = t - offset
            k = bisect.bisect_right(keys, h) - 1
            if k >= 0:
                # the latest span to start at or before h, or the nearest
                # of its ancestors still open at h: spans nest, so that is
                # the innermost span open at h
                owner = starts[k]
                while owner >= 0 and spans[owner][2] < h:
                    owner = spans[owner][3]
        out[owner] = out.get(owner, 0) + (b - a)
    return out


@contextlib.contextmanager
def profiled():
    """torch.profiler over CUDA activity (the kernels, copies and the CUDA
    runtime's records of their launches; no host op records), with a clock
    anchor: after the synchronise, MARKERS one-element fills, each bracketed
    by two reads of time.perf_counter_ns. Yields a dict filled on exit:
    `events` [(start, end, name)] and `corr` (their correlation ids) of the
    device, `launches` {correlation id: the start of its launch record},
    the host clock at the window's start and end, `offset` (trace = host +
    offset) and `anchor_err_ns` (the most the offset can be off)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    marker.fill_(0.0)  # its kernel loaded before the window
    torch.cuda.synchronize()
    out, brackets = {}, []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(MARKERS):
            h0 = time.perf_counter_ns()
            marker.fill_(1.0)
            brackets.append((h0, time.perf_counter_ns()))
        torch.cuda.synchronize()
        out["host_start_ns"] = time.perf_counter_ns()
        yield out
        torch.cuda.synchronize()
        out["host_end_ns"] = time.perf_counter_ns()
    res = prof.profiler.kineto_results
    events, corr, first, launch_recs = [], [], {}, []
    for e in res.events():
        c = e.correlation_id()
        if e.device_type() == DeviceType.CUDA:
            events.append((e.start_ns(), e.end_ns(), e.name()))
            corr.append(c)
        elif c:  # a runtime record (the launch, and what the launch waited on)
            s = e.start_ns()
            first[c] = min(first.get(c, s), s)
            if "LaunchKernel" in e.name():
                launch_recs.append((s, e.end_ns(), c))
    # the first launches of the window are the markers: no other comes first
    markers = sorted(launch_recs)[:MARKERS]
    if len(markers) < MARKERS:
        raise RuntimeError(f"profiled: {len(launch_recs)} kernel launch records, fewer than "
                           f"the {MARKERS} markers: the profiler gave no CUDA runtime records")
    out["offset"], out["anchor_err_ns"] = anchor(
        [(h0, h1, r0, r1) for (h0, h1), (r0, r1, _) in zip(brackets, markers)])
    mark = {c for _, _, c in markers}  # the markers' kernels are not the frame's
    keep = [i for i, c in enumerate(corr) if c not in mark]
    out["events"] = [events[i] for i in keep]
    out["corr"] = [corr[i] for i in keep]
    kernel_corr = set(out["corr"])
    out["launches"] = {c: s for c, s in first.items() if c in kernel_corr}
    out["trace_start_ns"] = res.trace_start_ns()


# ---------------------------------------------------------------------------
# the profiled frame by program span


def in_window(rec):
    """Indices of the program spans that overlap the profiled window."""
    a, b = rec.prof["host_start_ns"], rec.prof["host_end_ns"]
    return [i for i, s in enumerate(rec.program.spans) if s[1] < b and s[2] > a]


def attributed(rec) -> dict:
    """{span index or -1: device ns} of the profiled frame (`attribute`),
    cached on rec."""
    if rec.prof is None or rec.program is None:
        return {}
    if not hasattr(rec, "_attributed"):
        p = rec.prof
        kernels = [(a, b, n, c) for (a, b, n), c in zip(p["events"], p["corr"])]
        rec._attributed = attribute(kernels, p["launches"], rec.program.spans, p["offset"])
    return rec._attributed


def idle_by_span(rec) -> dict:
    """{span index or -1: ns}: the device's idle time in the profiled frame,
    each instant given to the innermost program span open on the host then
    (-1: none), cached on rec."""
    if rec.prof is None or rec.program is None:
        return {}
    if hasattr(rec, "_idle"):
        return rec._idle
    p, spans = rec.prof, rec.program.spans
    off = p["offset"]
    _, _, _, union = trace.device_summary(p["events"])
    idle = trace.idle_gaps(union, p["host_start_ns"] + off, p["host_end_ns"] + off)
    starts = [a for a, _ in idle]
    cum = [0]
    for a, b in idle:
        cum.append(cum[-1] + b - a)

    def idle_in(a, b):  # idle ns inside [a, b] (trace clock)
        if b <= a:
            return 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        j = bisect.bisect_left(starts, b)
        total = cum[j] - cum[i]
        if i < len(idle):  # trim the first and last gaps to [a, b]
            total -= max(0, min(a, idle[i][1]) - idle[i][0])
        if j - 1 >= i and j - 1 < len(idle):
            total -= max(0, idle[j - 1][1] - max(b, idle[j - 1][0]))
        return total

    children: dict = {}
    win = in_window(rec)
    for i in win:
        children.setdefault(spans[i][3], []).append(i)
    out = {}
    lo, hi = p["host_start_ns"], p["host_end_ns"]

    def own(kids, a, b):  # idle in [a, b] (host clock) less the kids' intervals
        cur, tot = a, 0
        for c in sorted(kids, key=lambda c: spans[c][1]):
            ca, cb = max(spans[c][1], a), min(spans[c][2], b)
            if cb > ca:
                tot += idle_in(cur + off, ca + off)
                cur = max(cur, cb)
        return tot + idle_in(cur + off, b + off)

    in_win = set(win)
    for i in win:
        out[i] = own(children.get(i, ()), max(spans[i][1], lo), min(spans[i][2], hi))
    # -1: the window less the spans that open in it with no parent in it
    out[-1] = own([i for i in win if spans[i][3] not in in_win], lo, hi)
    rec._idle = out
    return out


def _under(rec, i, names) -> bool:
    """Span i or one of its ancestors is named in `names` (a tuple of names,
    or of prefixes ending in '.')."""
    spans = rec.program.spans
    while i >= 0:
        n = spans[i][0]
        if n in names or any(x.endswith(".") and n.startswith(x) for x in names):
            return True
        i = spans[i][3]
    return False


def idle_pct(rec, names):
    """The share of the profiled frame's wall in which the device is idle
    while the host is inside a span of `names` (or under one) and inside no
    sync.* span, in percent."""
    idle = idle_by_span(rec)
    if not idle:
        return None
    wall = rec.prof["host_end_ns"] - rec.prof["host_start_ns"]
    spans = rec.program.spans
    ns = sum(v for i, v in idle.items()
             if i >= 0 and not spans[i][0].startswith("sync.") and _under(rec, i, names))
    return 100.0 * ns / wall


def idle_dispatch_pct(rec, integrator):
    """Idle while the host dispatches the integrator's work (not syncing)."""
    return idle_pct(rec, INTEGRATOR[integrator])


def idle_driver_pct(rec):
    """Idle while the host is in the driver's own steps (driver.*: the lane
    maps, the readback, the framebuffer's accumulation)."""
    return idle_pct(rec, ("driver.",))


def host_syncs_per_frame(rec):
    """sync.* spans a frame over the window."""
    if rec.program is None or not rec.n_frames:
        return None
    a, b = rec.window_ns
    n = sum(1 for s in rec.program.spans if s[0].startswith("sync.") and a <= s[1] <= b)
    return n / rec.n_frames


def sppm_compensate_device_ms(rec):
    """Device ms of the kernels launched inside sppm.grid.compensate, a grid
    build, in the profiled frame."""
    att = attributed(rec)
    spans = rec.program.spans if rec.program is not None else []
    builds = [i for i in in_window(rec) if spans[i][0] == "sppm.grid.compensate"] if att else []
    if not builds:
        return None
    return sum(att.get(i, 0) for i in builds) / len(builds) / 1e6


def live_lane_pct(rec):
    """walk.live over walk.lanes, the window's walk calls, in percent."""
    if rec.program is None:
        return None
    lanes = rec.program.counts.get("walk.lanes", 0) - rec.lanes0
    live = rec.program.totals.get("walk.live")
    return 100.0 * live / lanes if lanes and live is not None else None


def flatten_packs_s(rec):
    """Host seconds in flatten.packs and flatten.gbvh, in set-up."""
    if rec.program is None:
        return None
    ns = sum(b - a for name in ("flatten.packs", "flatten.gbvh")
             for a, b in rec.program.intervals(name))
    return ns / 1e9 if ns else None


def gap_labels(rec, top=10):
    """The profiled frame's longest idle gaps, each labelled by the innermost
    program span open at its middle ("outside" where none is)."""
    if rec.prof is None or rec.program is None:
        return None
    p = rec.prof
    _, _, _, union = trace.device_summary(p["events"])
    gaps = trace.idle_gaps(union, p["host_start_ns"] + p["offset"],
                           p["host_end_ns"] + p["offset"])
    spans = {}
    for name, a, b, _ in rec.program.spans:
        spans.setdefault(name, []).append((a, b))
    return trace.label_gaps(gaps, spans, p["offset"], top)


def by_name(rec, per_span: dict) -> dict:
    """{span name ("outside" for -1): ns} of a {span index: ns} map."""
    spans = rec.program.spans
    out = {}
    for i, ns in per_span.items():
        name = spans[i][0] if i >= 0 else "outside"
        out[name] = out.get(name, 0) + ns
    return out
