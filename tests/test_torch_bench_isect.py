"""The port's intersector benchmark (tungsten_tpu_torch/tools/bench_isect.py)
on the CPU: the `small` scene at n = 2,048, where every walk is its plain
twin. Every agreement the tool prints must reach its 99.9% bar, and every
kernel name it cannot serve must raise with its reason.
"""
import copy

import pytest

from tungsten_tpu_torch import synth
from tungsten_tpu_torch.ops import bvh, bvh2, bvh8, gather_bvh, intersect_stream
from tungsten_tpu_torch.tools import bench_isect

COUNTERS = ((bvh8.walk_cuda, bvh8.walk_twin), (bvh8.walk_fast_cuda, bvh8.walk_fast_twin),
            (bvh2.walk3_cuda, bvh2.walk3_twin),
            (bvh.walk_packet_cuda, bvh.walk_packet_twin),
            (intersect_stream.stream_cuda, intersect_stream.stream_twin),
            (gather_bvh.walk_cuda, gather_bvh.walk_twin))


def test_entry_point_on_small(tmp_path, capsys):
    path = synth.write_scene(str(tmp_path / "small"), "small")
    before = [(copy.copy(k.launches), copy.copy(t.launches)) for k, t in COUNTERS]
    res = bench_isect.main(["--scene", path, "--device", "cpu", "--n", "2048", "--trials", "1"])
    out = capsys.readouterr().out
    assert res["device"] == "cpu" and res["n"] == 2048 and res["n_tris"] > 2000
    assert set(res["times"]) == {(k, n) for k in bench_isect.RAY_KINDS
                                 for n in bench_isect.KERNELS}
    for (kind, _), r in res["times"].items():
        assert r["ms"] is None and r["twin_ms"] > 0.0  # the CPU runs only the twins
        assert (r["work"]["box"] > 0) == (kind != "dead")  # dead rays do no work
    for (kernel, twin), (k0, t0) in zip(COUNTERS, before):
        assert kernel.launches == k0
        if isinstance(t0, dict):  # K4 and K5: one count per mode
            assert all(twin.launches[m] > t0[m] for m in t0)
        else:
            assert twin.launches > t0
    # brute force for each of the 12 walks (+ t for the 9 closest-hit ones),
    # K4 vs K5 (mask and t), each of the 3 any-hit walks vs its closest-hit
    # walk, and each of the 11 other walks vs K2 on the coherent rays
    assert len(res["agree"]) == 12 + 9 + 2 + 3 + 11
    assert all(v >= bench_isect.BAR for v in res["agree"].values()), res["agree"]
    assert out.count("agreement ") == len(res["agree"])
    assert out.count("not run (CPU)") == 36
    # K1 tests 8 slabs a node round and 8 triangles a leaf round
    work = res["times"][("coherent", "gather")]["work"]
    assert work["box"] == 8 * work["node"] > 0 and work["tri"] == 8 * work["leaf"] > 0
    # the whole fast query does the raw fast walk's work plus the repair walk's
    for kind in ("coherent", "incoherent"):
        raw, whole = (res["times"][(kind, n)]["work"] for n in ("bvh8fast", "bvh8fastq"))
        assert whole["box"] >= raw["box"] and whole["tri"] >= raw["tri"]


@pytest.mark.parametrize("name,reason", [("bvhx", "pallas_bvhx"), ("bvh9", "unknown")])
def test_unsupported_kernels_raise(name, reason):
    with pytest.raises(ValueError, match=reason):
        bench_isect.main(["--device", "cpu", "--n", "16", "--kernels", f"bvh8,{name}"])


def test_v1_walks_by_name(tmp_path):
    """The first CUDA forms kept for comparison (v1: K3, K3-fast, K4 in its
    three modes, K5 in both modes, K2) run by name: on the CPU their twins (the same as the new
    walks'), and every agreement holds; the v1 kernels' counts do not move."""
    path = synth.write_scene(str(tmp_path / "small"), "small")
    pairs = (("bvh8", "bvh8v1"), ("bvh8any", "bvh8anyv1"), ("bvh8fast", "bvh8fastv1"),
             ("bvh3", "bvh3v1"), ("bvh3skip", "bvh3skipv1"), ("bvh3any", "bvh3anyv1"),
             ("bvh", "bvhv1"), ("bvh1", "bvh1v1"), ("tri", "triv1"))
    names = [n for pair in pairs for n in pair]
    assert set(bench_isect.V1_KERNELS) == {v1 for _, v1 in pairs}
    v1 = (bvh8.walk_cuda_v1, bvh8.walk_fast_cuda_v1, bvh2.walk3_cuda_v1,
          bvh.walk_packet_cuda_v1, intersect_stream.stream_cuda_v1)
    before = [copy.copy(k.launches) for k in v1]
    res = bench_isect.main(["--scene", path, "--device", "cpu", "--n", "1024", "--trials", "1",
                            "--kernels", ",".join(names)])
    assert [k.launches for k in v1] == before
    assert set(res["times"]) == {(k, n) for k in bench_isect.RAY_KINDS for n in names}
    for kind in ("coherent", "incoherent"):
        for a, b in pairs:
            assert res["times"][(kind, a)]["work"] == res["times"][(kind, b)]["work"]
    assert "bvh8anyv1 vs bvh8v1: hit mask" in res["agree"]
    assert "bvh3anyv1 vs bvh3v1: hit mask" in res["agree"]
    for name in ("bvh3v1", "bvh3skipv1", "bvh3anyv1", "bvhv1", "bvh1v1", "triv1"):
        assert res["agree"][f"{name} vs brute: hit mask"] >= bench_isect.BAR
    assert all(v >= bench_isect.BAR for v in res["agree"].values()), res["agree"]
