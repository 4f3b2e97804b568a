"""The program's recorder (tungsten_tpu_torch/utils/trace.py), on the CPU.

  * off, a small regen render and an SPPM iteration run no torch op from
    trace.py (so allocate no tensor there) but the reads `to_host` makes
    for its callers, and `span()` stays the shared no-op (a
    TorchDispatchMode sees every op and the frame that issued it); on, the
    same renders give the same images bit for bit;
  * nesting, parents, phases and self time;
  * device counters stay on the device, one accumulator a counter, until
    the recording closes, and are read then, once a counter; a recording
    that joins an open one reads its own counters when it ends;
  * the benchmark's clock anchor (port_bench/harness/program.py) against
    record_function markers under a CPU profiler, within 1 ms;
  * its kernel attribution as a pure function: every kernel counted once,
    each by the innermost span open at its launch;
  * on a small scene, the pt.iter spans equal the benchmark Tracer's
    shading count and walk.lanes its rays() sum, exactly
    (port_bench/harness/trace.py wraps the same calls from outside).
"""
import collections
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tungsten_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_PY = os.path.join("utils", "trace.py")


TORCH_DIR = os.path.dirname(torch.__file__)


class OpsFromTrace(TorchDispatchMode):
    """Counts every torch op, and the ops that utils/trace.py issued (its
    frame the innermost one outside torch's own files)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.from_trace = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename.startswith(TORCH_DIR):
            f = f.f_back
        if f is not None and f.f_code.co_filename.endswith(TRACE_PY):
            self.from_trace[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """small (regen) and small-box's caustic (SPPM), flattened on the CPU."""
    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    out = {}
    for size, variant in (("small", None), ("small-box", "progressive_photon_map+caustic")):
        d = str(tmp_path_factory.mktemp(size))
        path = synth.write_scene(d, size, variant) if variant else synth.write_scene(d, size)
        out[size] = flatten_scene(load_scene(path), torch.device("cpu"))
    return out


def regen(scene):
    from tungsten_tpu_torch.renderer.render import render_buffers
    return render_buffers(scene, spp=1, seed=7, wavefront="regen").color()


def sppm(scene):
    from tungsten_tpu_torch.renderer.render import render_sppm
    return render_sppm(scene, spp=1, seed=7, photons_per_iter=1 << 10)


def bench_program():
    """port_bench/harness/program.py: the benchmark's reading of a recording
    against a device trace (the clock anchor, kernel attribution)."""
    sys.path.insert(0, os.path.join(REPO, "port_bench"))
    from harness import program
    return program


READS = {"aten._local_scalar_dense.default", "aten._to_copy.default"}


def test_off_runs_nothing_of_its_own(scenes, monkeypatch):
    """Off, the only ops trace.py issues are the reads to_host makes for its
    callers, at most one a call."""
    reads = []
    to_host = trace.to_host
    monkeypatch.setattr(trace, "to_host", lambda site, t: reads.append(site) or to_host(site, t))
    assert trace.REC is None and trace.span("pt.iter") is trace.OFF
    images = {}
    for name, render, scene in (("regen", regen, scenes["small"]),
                                ("sppm", sppm, scenes["small-box"])):
        mode = OpsFromTrace()
        reads.clear()
        with mode:
            images[name] = render(scene)
        assert mode.ops > 1000 and set(mode.from_trace) <= READS, (name, mode.from_trace)
        # a read of a CPU tensor to the CPU (the readback here) issues no op
        assert 0 < sum(mode.from_trace.values()) <= len(reads)
        assert trace.REC is None and trace.span("sppm.iter") is trace.OFF
        on = OpsFromTrace()
        with trace.recording() as rec, on:
            image = render(scene)
        assert np.array_equal(image, images[name])
        assert sum(on.from_trace.values()) > 0 and len(rec.spans) > 10


def test_nesting_parents_and_self_time():
    with trace.recording(counters=()) as rec:
        with trace.span("a"):
            with trace.span("b") as b:
                b.phase("c")
                time.sleep(0.002)
                b.phase("d")
                b.phase(None)
                time.sleep(0.001)
            with trace.span("e"):
                assert rec.innermost() == "e"
        assert rec.innermost() is None
    names = [s[0] for s in rec.spans]
    parents = [s[3] for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e"] and parents == [-1, 0, 1, 1, 0]
    assert all(s[1] <= s[2] for s in rec.spans)
    assert rec.spans[2][2] <= rec.spans[3][1] <= rec.spans[3][2] <= rec.spans[1][2]
    own = rec.self_ns()
    wall = {s[0]: s[2] - s[1] for s in rec.spans}
    assert own["a"] == wall["a"] - wall["b"] - wall["e"]
    assert own["b"] == wall["b"] - wall["c"] - wall["d"] >= 1_000_000
    assert own["c"] == wall["c"] >= 2_000_000


def test_spanned_and_to_host():
    @trace.spanned("f")
    def f(x):
        return trace.to_host("sync.f", x.sum())

    x = torch.arange(4)
    assert f(x) == 6  # off: a plain call and a plain read
    with trace.recording(counters=()) as rec:
        assert f(x) == 6 and f.__name__ == "f"
        assert torch.equal(trace.to_host("sync.g", x), x)
    assert [(s[0], s[3]) for s in rec.spans] == [("f", -1), ("sync.f", 0), ("sync.g", -1)]


def test_device_counters_read_once_at_close():
    local = collections.Counter()

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            local[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Reads():
        with trace.recording(counters=("walk.live", "light.choices")) as rec:
            for k in range(50):
                t = torch.full((10,), float(k))
                with trace.walk(10, torch.zeros(10), t):
                    pass
                # one accumulator a counter, grown to the widest size given
                rec.index_add("light.choices", 2 + k % 3, torch.tensor([k % 2]),
                              torch.tensor([True]))
            assert rec.counts["walk.lanes"] == 500
            assert local["aten._local_scalar_dense.default"] == 0 and not rec.totals
        assert local["aten._local_scalar_dense.default"] == 1  # one read a counter
        assert local["aten._to_copy.default"] == 1 + 50  # walk.live's first; the bools
    assert rec.totals == {"walk.live": 490, "light.choices": [25, 25, 0, 0]}
    with trace.recording(counters=("bsdf.hits",)) as outer:
        outer.index_add("bsdf.hits", 2, torch.tensor([0, 1, 1]), torch.tensor([1, 1, 1]))
        with trace.recording(counters=("bsdf.hits",)) as inner:
            assert inner is outer
            inner.index_add("bsdf.hits", 3, torch.tensor([0, 2]), torch.tensor([5, 1]))
        assert outer.totals["bsdf.hits"] == [5, 0, 1]
        outer.index_add("bsdf.hits", 2, torch.tensor([0, 1]), torch.tensor([1, 1]))
        outer.add("walk.live", torch.tensor(3))  # not counted here: ignored
    assert outer.totals == {"bsdf.hits": [2, 3]}
    with trace.recording(counters=("walk.live",)) as empty:
        pass
    assert empty.totals == {"walk.live": 0}


def test_walk_spans_the_outermost_call_only():
    with trace.recording() as rec:
        with trace.walk(4, torch.zeros(4), torch.ones(4)):
            with trace.walk(4, torch.zeros(4), torch.ones(4)):
                pass
    assert [s[0] for s in rec.spans] == ["pt.walk"]
    assert rec.counts["walk.lanes"] == 4 and rec.totals == {"walk.live": 4}


def test_clock_anchor_against_markers():
    """A CPU profile's user annotations stand in for the launch records: the
    anchor from one marker places the others' host times within 1 ms."""
    program = bench_program()
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    brackets, inside = [], []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(4):
            h0 = time.perf_counter_ns()
            with record_function(f"anchor{k}"):
                pass
            brackets.append((h0, time.perf_counter_ns()))
        for k in range(5):
            time.sleep(0.003)
            with record_function(f"mark{k}"):
                inside.append(time.perf_counter_ns())
    events = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()}
    offset, err = program.anchor([(h0, h1) + events[f"anchor{k}"]
                                for k, (h0, h1) in enumerate(brackets)])
    assert 0 <= err < 1e6
    for k, h in enumerate(inside):
        a, b = events[f"mark{k}"]
        assert a - 1_000_000 <= h + offset <= b + 1_000_000
    with pytest.raises(ValueError):
        program.anchor([])


def test_attribution_counts_every_kernel_once():
    program = bench_program()
    spans = [["frame", 0, 100, -1], ["pt.batch", 10, 90, 0], ["pt.iter", 10, 40, 1],
             ["pt.walk", 20, 30, 2], ["pt.iter", 50, 80, 1], ["driver.readback", 92, 99, 0]]
    off = 10 ** 18
    launches = {1: 5, 2: 25, 3: 35, 4: 45, 5: 60, 6: 95, 7: 100, 8: 150}
    kernels = [(1000, 1000 + 7 * c, f"k{c}", c) for c in range(1, 10)]  # 9: no record
    got = program.attribute(kernels, {c: t + off for c, t in launches.items()}, spans, off)
    # 2: in the walk; 3: the walk ended, its iteration open; 4: between the
    # iterations; 7: at the frame's last ns; 8: after it; 9: no record
    assert got == {0: 7 * (1 + 7), 3: 7 * 2, 2: 7 * 3, 1: 7 * 4, 4: 7 * 5, 5: 7 * 6,
                   -1: 7 * (8 + 9)}
    assert sum(got.values()) == sum(b - a for a, b, _, _ in kernels)
    assert program.attribute(kernels, {}, [], 0) == {-1: sum(7 * c for c in range(1, 10))}


def test_counts_match_the_benchmark_tracer(scenes):
    bench_program()
    from harness import trace as bench_trace
    from tungsten_tpu_torch.renderer.render import render_buffers

    tracer = bench_trace.Tracer(sync=False)
    with tracer, trace.recording() as rec:
        render_buffers(scenes["small"], spp=2, seed=3, passes_per_batch=1, wavefront="regen")
        render_buffers(scenes["small"], spp=1, seed=3, wavefront="lockstep")
    names = collections.Counter(s[0] for s in rec.spans)
    assert names["pt.iter"] == tracer.counts["shading"] > 0
    assert rec.counts["walk.lanes"] == sum(tracer.rays())
    assert names["pt.walk"] == tracer.walk_calls
    assert names["pt.batch"] == 3 and names["frame"] == 2
    # each regen loop ends on a read; the lockstep loop may end at its bounce cap
    assert names["pt.iter"] + 2 <= names["sync.pt.loop"] <= names["pt.iter"] + 3
