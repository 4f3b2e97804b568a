"""The comparison that decides `correct`, at the small sizes on the CPU: the
reference against brute force, sound runs, the bfloat16 control and the
faults planted under the timed path."""
import numpy as np
import pytest
import torch

import control
import faults
import scenes
from harness import check, run
from reference.bvh import Bvh, _moller_trumbore
from reference.scene import load
from small_cells import small_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_walk_against_brute_force(tmp_path):
    path = scenes.write_scene(str(tmp_path), small_cell("materialtest-pt").config)
    s = load(path, CPU)
    bvh = Bvh(s.v0, s.v1, s.v2)
    g = torch.Generator().manual_seed(3)
    n = 256
    o = torch.rand(n, 3, generator=g) * torch.tensor([6.0, 3.0, 6.0]) - torch.tensor(
        [3.0, -0.2, 3.0])
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    near, far = torch.full((n,), 1e-4), torch.full((n,), float("inf"))
    t, tri, _, _ = bvh.query(o, d, near, far)
    _, any_tri, _, _ = bvh.query(o, d, near, far, any_hit=True)
    tt, _, _ = _moller_trumbore(o[:, None], d[:, None], s.v0[None].expand(n, -1, -1),
                                (s.v1 - s.v0)[None].expand(n, -1, -1),
                                (s.v2 - s.v0)[None].expand(n, -1, -1))
    tt = torch.where(tt > 1e-4, tt, torch.full_like(tt, float("inf")))
    bt, bi = tt.min(1)
    hit = torch.isfinite(bt)
    assert hit.any() and (~hit).any()
    assert torch.equal(tri[hit], bi[hit]) and torch.allclose(t[hit], bt[hit])
    assert (tri[~hit] < 0).all() and torch.equal(any_tri >= 0, hit)


@pytest.mark.parametrize("name", ["materialtest-pt", "box-caustic-sppm"])
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    res, lines = run.run_cell(cell, 2 ** 31 + 7, 0.5, False, CPU, 0.0, native=False)
    assert res["correct"], lines
    assert list(res["check"]) == ["z_max", "z2_mean", "noise"] and res["attempted"] >= 1


@pytest.mark.parametrize("name", ["materialtest-pt", "box-caustic-pt", "box-caustic-sppm"])
def test_control_fails(name):
    """The reference in bfloat16, put in the program's place, fails the
    cell's limits (step 2 of the comparison's rules), on three seeds."""
    cell = small_cell(name, spp=8)
    out = control.readings(cell, 2 ** 31 + 11, 0, 3, CPU, native=False)
    lim = cell.cell["limits"]
    for r in out["control"]:
        assert any(r[k] > lim[k] for k in lim), r


@pytest.mark.parametrize("name,kind", [(n, k) for n in ("materialtest-pt", "box-caustic-sppm")
                                         for k in faults.KINDS[
                                             "progressive_photon_map" if "sppm" in n
                                             else "path_tracer"]])
def test_faults_fail(monkeypatch, name, kind):
    """A run with the timed path broken underneath reads `correct` false on
    every frame. The cells run on one chip: no exchange between chips can
    be left out."""
    cell = small_cell(name)
    faults.plant(kind, cell.traffic["integrator"], monkeypatch.setattr)
    res, lines = run.run_cell(cell, 2 ** 31 + 5, 0.5, False, CPU, 0.0, native=False)
    assert not res["correct"] and res["failed"] == res["attempted"], lines


@pytest.mark.cuda
def test_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell("materialtest-pt", spp=8)
    out = control.readings(cell, 2 ** 31 + 13, 1, 3, torch.device("cuda"), native=False)
    lim = cell.cell["limits"]
    assert all(r[k] <= lim[k] for r in out["sound"] for k in lim)
    assert all(any(r[k] > lim[k] for k in lim) for r in out["control"])


def test_compare_reads_infinity_for_non_finite_frames():
    m = torch.ones((40, 40, 3), dtype=torch.float64)
    v = torch.full_like(m, 0.1)
    frame = np.ones((40, 40, 3), np.float32)
    assert check.compare(frame, m, v, 4, 4)["z_max"] == 0.0
    frame[3, 3, 1] = np.nan
    assert check.compare(frame, m, v, 4, 4) == {"z_max": float("inf"), "z2_mean": float("inf")}


def test_noise_measures_the_frames_variance():
    """Two frames of per-pixel variance s^2 / spp read about 1 against a
    reference per-sample variance s^2; at half the samples about 2; each
    frame is paired with the next, the last with the first."""
    g = torch.Generator().manual_seed(5)
    mean = torch.rand((96, 128, 3), generator=g, dtype=torch.float64)
    var = torch.full_like(mean, 0.04)

    def frame(spp):
        return (mean + torch.randn(mean.shape, generator=g, dtype=torch.float64)
                * (0.04 / spp) ** 0.5).numpy()
    a, b, half = frame(32), frame(32), frame(16)
    assert check.noise(a, b, var, 32) == pytest.approx(1.0, abs=0.1)
    assert check.noise(half, frame(16), var, 32) == pytest.approx(2.0, abs=0.2)
    out = check.judge([a, b], [], mean, var, 4, 32)
    assert [r["noise"] for r in out] == [check.noise(a, b, var, 32)] * 2
    assert check.judge([a], [half], mean, var, 4, 32)[0]["noise"] == check.noise(a, half, var, 32)
