"""The program's own spans and counters: off unless a recording is open.

`recording()` opens a Recording and makes it the module's `REC` until the
block ends; closing it reads its device counters to the host, once. While
none is open (`REC is None`), `span(name)` returns one shared no-op context
manager and every other entry point returns after one `is None` test: off,
the recorder allocates nothing, launches nothing and never synchronises.

A recording keeps, in memory:
- spans: [name, start, end, parent] on the host clock (time.perf_counter_ns),
  parent the index of the span open around it (-1 at the top). A span
  opened by `with span(name) as s` can hold a run of phases, children one
  after another (`s.phase(name)` ends the current one and starts the next);
- host counters (`count`);
- device counters (`add`, `index_add`, where the recording counts the
  name): one int64 accumulator a counter, left on the device and read when
  the recording closes (or when a `recording(counters=...)` that joined an
  open one ends).

Every device-to-host read of the main paths goes through `to_host(site, t)`,
under a span named `sync.<site>`: the count of sync.* spans is the count of
host syncs. The walk entry points open `pt.walk` through `walk(...)` (the
outermost call only) with the counters walk.lanes (host) and walk.live
(lanes whose interval is not empty).
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

REC = None  # the open Recording; None while the recorder is off

WALK_COUNTERS = ("walk.live",)


class Recording:
    """Spans, host counters and device counters of one recording."""

    def __init__(self, counters=WALK_COUNTERS):
        self.spans: list = []  # [name, start_ns, end_ns, parent]; end -1 while open
        self.counts: dict = {}  # host counters
        self.device: dict = dict.fromkeys(counters)  # accumulators; None until added to
        self.totals: dict = {}  # device counters read to the host
        self._open: list = []  # indices of the open spans, innermost last

    def begin(self, name: str) -> int:
        self.spans.append([name, time.perf_counter_ns(), -1,
                           self._open[-1] if self._open else -1])
        self._open.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def end(self, i: int):
        if i not in self._open:  # ended already, with a span around it
            return
        now = time.perf_counter_ns()
        while True:  # a span left open inside i ends with it
            j = self._open.pop()
            self.spans[j][2] = now
            if j == i:
                break

    def innermost(self):
        """The name of the innermost open span, or None."""
        return self.spans[self._open[-1]][0] if self._open else None

    def count(self, name: str, n=1):
        self.counts[name] = self.counts.get(name, 0) + n

    def add(self, name: str, value: torch.Tensor):
        """Add a 0-d tensor to the device counter `name` where this
        recording counts it (one launch, no sync)."""
        if name not in self.device:
            return
        acc = self.device[name]
        if acc is None:
            self.device[name] = value.to(torch.int64, copy=True)
        else:
            acc.add_(value)

    def index_add(self, name: str, size: int, index: torch.Tensor, source: torch.Tensor):
        """Add source[i] to slot index[i] of the device counter `name`, a
        vector grown to `size` slots, where this recording counts it (one
        index_add_, no sync)."""
        if name not in self.device:
            return
        acc = self.device[name]
        if acc is None:
            acc = torch.zeros(size, dtype=torch.int64, device=index.device)
        elif acc.numel() < size:
            acc = torch.cat([acc, acc.new_zeros(size - acc.numel())])
        self.device[name] = acc.index_add_(0, index, source.to(torch.int64))

    def read(self, names):
        """Read the named device counters to the host (one read a counter)
        into `totals`: a number, a list for a vector, 0 where nothing was
        added."""
        for name in names:
            acc = self.device.pop(name, None)
            self.totals[name] = 0 if acc is None else acc.item() if acc.dim() == 0 else acc.tolist()

    def close(self):
        now = time.perf_counter_ns()
        for i in self._open:
            self.spans[i][2] = now
        self._open.clear()
        self.read(list(self.device))

    # ---- reading the spans ----
    def intervals(self, name: str) -> list:
        """[(start_ns, end_ns)] of the spans called `name`."""
        return [(s[1], s[2]) for s in self.spans if s[0] == name]

    def self_ns(self, since: int = 0, until=None) -> dict:
        """{name: ns}: each span's wall less its children's, summed by name,
        over the spans that start in [since, until]."""
        def kept(a):
            return a >= since and (until is None or a <= until)

        out = {}
        for name, a, b, _ in self.spans:
            if kept(a):
                out[name] = out.get(name, 0) + (b - a)
        for name, a, b, parent in self.spans:
            if parent >= 0 and kept(a) and kept(self.spans[parent][1]):
                out[self.spans[parent][0]] -= b - a
        return out


class _Span:
    __slots__ = ("rec", "name", "i", "child")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name, self.child = rec, name, None

    def __enter__(self):
        self.i = self.rec.begin(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.end(self.i)
        return False

    def phase(self, name):
        """End the current phase (a child span) and start `name` (None: no
        phase)."""
        if self.child is not None:
            self.rec.end(self.child)
            self.child = None
        if name is not None:
            self.child = self.rec.begin(name)


class _Off:
    """The shared no-op span of the recorder when off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def phase(self, name):
        pass


OFF = _Off()


def span(name: str):
    """A context manager that records the span `name` while a recording is
    open (`OFF` otherwise). `with span(n) as s: s.phase(child)` records a
    run of child phases."""
    rec = REC
    return OFF if rec is None else _Span(rec, name)


def spanned(name: str):
    """Decorator: every call of the function is the span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec = REC
            if rec is None:
                return fn(*args, **kwargs)
            with _Span(rec, name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def to_host(site: str, t: torch.Tensor):
    """Read `t` to the host under the span `site` (a `sync.` name): a
    Python number from a 0-d tensor, else a CPU tensor."""
    rec = REC
    if rec is None:
        return t.item() if t.dim() == 0 else t.cpu()
    with _Span(rec, site):
        return t.item() if t.dim() == 0 else t.cpu()


def counter(name: str):
    """The open recording where it counts the device counter `name`, else
    None (one `is None` test while off)."""
    rec = REC
    return rec if rec is not None and name in rec.device else None


def walk(n: int, tnear, tfar):
    """The span `pt.walk` of a walk of n lanes over [tnear, tfar], with its
    counters: three launches, no sync. A walk inside a walk is not recorded
    again."""
    rec = REC
    if rec is None or rec.innermost() == "pt.walk":
        return OFF
    rec.count("walk.lanes", n)
    if "walk.live" in rec.device:
        rec.add("walk.live", (tfar > tnear).sum())
    return _Span(rec, "pt.walk")


@contextlib.contextmanager
def recording(counters=WALK_COUNTERS):
    """Open a recording (or join the open one) that counts the device
    counters `counters` while the block runs; yields it. A recording that
    this block opened closes at its end; one it joined has the block's
    counters read (into `totals`) and stops counting them."""
    global REC
    rec = REC
    if rec is not None:  # join: count these counters for this block alone
        saved = {name: rec.device[name] for name in counters if name in rec.device}
        rec.device.update(dict.fromkeys(counters))
        try:
            yield rec
        finally:
            rec.read(counters)
            rec.device.update(saved)
        return
    rec = REC = Recording(counters)
    try:
        yield rec
    finally:
        REC = None
        rec.close()

