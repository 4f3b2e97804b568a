"""harness/program.py's readers on a synthetic record, on the CPU."""
import types

import pytest

from harness import program
from tungsten_tpu_torch.utils.trace import Recording

OFF = 1_000_000  # trace = host + OFF


def synthetic():
    """A frame (host 0-1000 ns) of one PT batch with two iterations and a
    driver readback. The device (trace clock): busy 100-300 (launched in
    pt.shade), 500-520 (in the compensate span, of an SPPM grid build
    placed inside the frame), 700-800 (pt.walk)."""
    rec = Recording()
    spans = [
        ["frame", 0, 1000, -1],  # 0
        ["pt.batch", 50, 850, 0],  # 1
        ["pt.iter", 60, 400, 1],  # 2
        ["pt.shade", 60, 200, 2],  # 3
        ["sync.pt.loop", 400, 450, 1],  # 4
        ["pt.iter", 450, 840, 1],  # 5
        ["pt.walk", 600, 650, 5],  # 6
        ["sppm.grid.compensate", 460, 480, 5],  # 7
        ["driver.readback", 860, 950, 0],  # 8
        ["sync.readback", 900, 950, 8],  # 9
    ]
    rec.spans = spans
    rec.counts = {"walk.lanes": 1500}
    rec.totals = {"walk.live": 900}
    events = [(100 + OFF, 300 + OFF, "shade"), (500 + OFF, 520 + OFF, "scan"),
              (700 + OFF, 800 + OFF, "walk")]
    prof = {"events": events, "corr": [1, 2, 3],
            "launches": {1: 70 + OFF, 2: 470 + OFF, 3: 610 + OFF},
            "host_start_ns": 0, "host_end_ns": 1000, "offset": OFF, "anchor_err_ns": 5}
    return types.SimpleNamespace(program=rec, prof=prof, window_ns=(0, 1000), n_frames=1,
                                 lanes0=500)


def test_attribution_keeps_every_kernel():
    rec = synthetic()
    att = program.attributed(rec)
    assert att == {3: 200, 7: 20, 6: 100}
    names = program.by_name(rec, att)
    assert names == {"pt.shade": 200, "sppm.grid.compensate": 20, "pt.walk": 100}
    assert program.sppm_compensate_device_ms(rec) == pytest.approx(20 / 1e6)


def test_idle_by_innermost_span():
    rec = synthetic()
    idle = program.by_name(rec, program.idle_by_span(rec))
    # idle on the trace clock: 0-100, 300-500, 520-700, 800-1000
    assert sum(idle.values()) == 100 + 200 + 180 + 200
    assert idle["frame"] == 50 + 10 + 50  # 0-50, 850-860, 950-1000
    assert idle["pt.batch"] == 10 + 10  # 50-60, 840-850
    assert idle["pt.iter"] == 100 + (10 + 100 + 90)  # 300-400; 450-460, 480-600, 650-840
    assert idle["pt.shade"] == 40 and idle["pt.walk"] == 50  # 60-100; 600-650
    assert idle["sppm.grid.compensate"] == 20 and idle["driver.readback"] == 40
    assert idle["sync.pt.loop"] == 50 and idle["sync.readback"] == 50
    assert -1 not in program.idle_by_span(rec) or program.idle_by_span(rec)[-1] == 0
    # under pt.batch and in no sync span: 20 + 300 + 40 + 50 + 20 of the 1000 ns
    assert program.idle_dispatch_pct(rec, "pt") == pytest.approx(43.0)
    assert program.idle_driver_pct(rec) == pytest.approx(4.0)


def test_counts_and_labels():
    rec = synthetic()
    assert program.host_syncs_per_frame(rec) == 2
    assert program.live_lane_pct(rec) == pytest.approx(90.0)
    assert program.flatten_packs_s(rec) is None
    rec.program.spans.append(["flatten.packs", -5000, -3000, -1])
    assert program.flatten_packs_s(rec) == pytest.approx(2e-6)
    labels = program.gap_labels(rec, top=2)
    assert [lab for lab, _ in labels] == ["sync.pt.loop", "sync.readback"]


def test_nothing_recorded_reads_none():
    rec = types.SimpleNamespace(program=None, prof=None, n_frames=0, lanes0=0)
    for read in (program.idle_driver_pct, program.host_syncs_per_frame,
                 program.sppm_compensate_device_ms, program.live_lane_pct,
                 program.flatten_packs_s, program.gap_labels):
        assert read(rec) is None
    assert program.idle_dispatch_pct(rec, "pt") is None
