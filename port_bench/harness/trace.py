"""Spans and counters the benchmark wraps around the program's calls, and the
reading of a profiler window.

`Tracer` replaces module attributes of the program for the length of a
`with` block (nothing is written into its files): each wrapped call records
a host-clock span, synchronised with the device at both edges (the traced
run only), and the walks' ray counts. The walk entry points are wrapped in
every module that binds them by name. `profile_window` reads the
profiler's raw kineto events (building the Python event tree for 10^5-10^6
kernels takes minutes) into the union of the device's busy intervals, the
device time by kernel name and the idle gaps between the intervals.
"""
from __future__ import annotations

import contextlib
import time

import torch

# (module, attribute, span name) the benchmark wraps
SPANS = (
    ("tungsten_tpu_torch.renderer.render", "render_buffers", "frame"),
    ("tungsten_tpu_torch.renderer.render", "render_sppm", "frame"),
    ("tungsten_tpu_torch.renderer.render", "trace_regen_batch", "pt.regen"),
    ("tungsten_tpu_torch.renderer.render", "trace_batch", "pt.lockstep"),
    ("tungsten_tpu_torch.integrators.photon_map", "trace_photons", "sppm.photons"),
    ("tungsten_tpu_torch.integrators.photon_map", "build_photon_grid", "sppm.grid"),
    ("tungsten_tpu_torch.integrators.photon_map", "gather_pass", "sppm.gather"),
)
# (module, attribute, counter): calls counted without a span
COUNTERS = (
    ("tungsten_tpu_torch.integrators.path_tracer", "_shading_data", "shading"),
)
# (module, attribute, kind): the walk entry points, with the rays they take
WALKS = tuple((m, a, k) for m in ("tungsten_tpu_torch.integrators.path_tracer",
                                  "tungsten_tpu_torch.integrators.photon_map")
              for a, k in (("_intersect", "closest"), ("_intersect_mixed", "mixed"),
                           ("_occluded_raw", "any")))


class Tracer:
    """Spans {name: [(start_ns, end_ns), ...]} (time.perf_counter_ns),
    counts {name: calls}, and the walk calls' rays: closest and any-hit,
    summed on the device (no sync) into `rays()`."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.spans: dict = {}
        self.counts: dict = {}
        self.walk_calls = 0
        self._closest = []
        self._any = []
        self._depth = 0
        self._saved = []

    def _span(self, fn, name):
        def wrapped(*a, **kw):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.spans.setdefault(name, []).append((t0, time.perf_counter_ns()))
        return wrapped

    def _count(self, fn, name):
        def wrapped(*a, **kw):
            self.counts[name] = self.counts.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    def _walk(self, fn, kind):
        def wrapped(scene, o, *a, **kw):
            outer = self._depth == 0
            if outer:
                n = o.shape[0]
                self.walk_calls += 1
                if kind == "mixed":  # latched lanes are any-hit
                    latch = a[-1] if a else kw["latch"]
                    n_any = latch.sum()
                    self._any.append(n_any)
                    self._closest.append(n - n_any)
                elif kind == "any":
                    self._any.append(n)
                else:
                    self._closest.append(n)
            self._depth += 1
            try:
                return fn(scene, o, *a, **kw)
            finally:
                self._depth -= 1
        return wrapped

    def rays(self):
        """(closest-hit rays, any-hit rays) of the walk calls so far."""
        return (int(sum(int(x) for x in self._closest)),
                int(sum(int(x) for x in self._any)))

    def mark(self):
        """A point to measure from: (spans, counts, walk calls, rays)."""
        return ({k: len(v) for k, v in self.spans.items()}, dict(self.counts), self.walk_calls,
                self.rays())

    def __enter__(self):
        import importlib
        for mod, attr, name in SPANS + COUNTERS + WALKS:
            m = importlib.import_module(mod)
            fn = getattr(m, attr, None)
            if fn is None:  # a module that does not bind this entry point
                continue
            if (mod, attr, name) in COUNTERS:
                new = self._count(fn, name)
            elif (mod, attr, name) in WALKS:
                new = self._walk(fn, name)
            else:
                new = self._span(fn, name)
            self._saved.append((m, attr, fn))
            setattr(m, attr, new)
        return self

    def __exit__(self, *exc):
        for m, attr, fn in reversed(self._saved):
            setattr(m, attr, fn)
        self._saved.clear()


@contextlib.contextmanager
def profiled():
    """torch.profiler over CUDA activity only (host op records would slow the
    host-paced loop). Yields a dict filled on exit: the host clock
    (perf_counter_ns) at the profiler's start and end and the raw events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        out["host_start_ns"] = time.perf_counter_ns()
        yield out
        torch.cuda.synchronize()
        out["host_end_ns"] = time.perf_counter_ns()
    res = prof.profiler.kineto_results
    events = []
    for e in res.events():
        if e.device_type() == DeviceType.CUDA:
            events.append((e.start_ns(), e.end_ns(), e.name()))
    out["events"] = events
    out["trace_start_ns"] = res.trace_start_ns()


def device_summary(events, kernel_only=True):
    """-> (busy ns: the union of the intervals, {name: [count, ns]}, kernels,
    the sorted union intervals)."""
    by_name, spans, kernels = {}, [], 0
    for a, b, name in events:
        spans.append((a, b))
        c = by_name.setdefault(name, [0, 0])
        c[0] += 1
        c[1] += b - a
        low = name.lower()
        kernels += "memcpy" not in low and "memset" not in low
    union, busy = [], 0
    for a, b in sorted(spans):
        if union and a <= union[-1][1]:
            if b > union[-1][1]:
                busy += b - union[-1][1]
                union[-1][1] = b
        else:
            union.append([a, b])
            busy += b - a
    return busy, by_name, kernels, union


def idle_gaps(union, start_ns, end_ns):
    """The device's idle intervals inside [start_ns, end_ns] (the kineto
    clock) between and around the busy intervals."""
    gaps, cur = [], start_ns
    for a, b in union:
        if a > cur:
            gaps.append((cur, min(a, end_ns)))
        cur = max(cur, b)
    if end_ns > cur:
        gaps.append((cur, end_ns))
    return [(a, b) for a, b in gaps if b > a]


def label_gaps(gaps, spans, offset_ns, top=10):
    """The longest gaps, each labelled by the innermost benchmark span open
    on the host at its middle ("outside" where none is): [[label, s], ...].
    offset_ns maps the host clock onto the kineto clock."""
    flat = [(a + offset_ns, b + offset_ns, name) for name, v in spans.items() for a, b in v]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]:
        mid = 0.5 * (a + b)
        open_ = [(s1 - s0, name) for s0, s1, name in flat if s0 <= mid <= s1]
        out.append([min(open_)[1] if open_ else "outside", (b - a) / 1e9])
    return out
