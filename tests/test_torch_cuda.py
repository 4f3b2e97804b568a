"""The port's CUDA kernel against its plain twin, on a card.

These tests need a CUDA card and nvcc; without a card they skip. The file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Kernels: K3 (bvh8_walk.cu: closest, any, mixed), K3-fast (bvh8_walk_fast.cu),
K4 (bvh2_walk.cu: ordered, skip, any), K5 (bvh_walk.cu: v2 and v1), K2
(intersect_stream.cu), K1 (gather_walk.cu: closest, any, mixed; bit for
bit with its twin, and by the bars against brute force) and K6
(grid_walk.cu: the exact voxel DDA's optical depth and its inverse, on
trilinear and nearest grids, bit for bit with its twin), K7
(photon_walk.cu: the photon-grid walk in its surface, kNN histogram,
points and beams modes, bit for bit with its twin), and the first CUDA forms of K3, K3-fast, K4, K5 and
K2, kept for comparison (bvh8_walk_v1.cu, bvh8_walk_fast_v1.cu,
bvh2_walk_v1.cu, bvh_walk_v1.cu, intersect_stream_v1.cu).
Bars: local slot (prim) agrees on >= 99.9%
of rays. Where it agrees, t is within rtol 1e-5 plus 1e-6 absolute on
>= 99.9% of hits and within rtol 1e-3 on all: the plane form's numerator
cancels to the point-plane distance, so its rounding error is absolute
(~eps * |o|) and grows as 1 / |cos| on grazing hits, and the kernel fuses
multiply-adds where the twin does not. K5's and K2's u and v are within
1e-5 on >= 99.9% and within 1e-3 on all (Moller-Trumbore's u cancels in
tv . p). K5 and K2 round each operation as their twins do, so they are
expected to agree bit for bit; the bars leave the room the other walks need.
K3 equals its v1 form bit for bit in every mode (one slot test, one
visiting order). K3-fast's tensor core sums the 12 products of a plane row
in its own order, so against its twin the slot agrees on >= 99.9% and t,
where the slot agrees, within rtol 1e-5 plus 1e-6 on >= 99.9% and rtol 1e-3
on all; the fast v1 form fixes the twin's order of additions and rounds
each operation as the twin does (every bf16 x bf16 product is exact in
f32), so it is held to bit equality of slot and t.
K5 tests its leaves per warp in the order and rounding of its first form:
in both modes it equals its twin and bvh_walk_v1.cu bit for bit. K2 culls
per ray and per sub-box where its twin votes per 256-ray tile, so a pair
accepted just outside its box through the slab test's rounding may be
culled: prim agrees with the twin on >= 99.99% of rays, and where it
agrees t, u and v are bit-equal; the first form of K2 keeps the tile vote
and equals the twin bit for bit.
K4's walks test their leaves per warp with K3's leaf step
(`slot_exact`), where its first form left its leaf arithmetic to the
compiler: against its twin and against bvh2_walk_v1.cu it is held to the
bars above; against exact K3 on the same rays (the two packs share their
plane leaves) the slot agrees on >= 99.99% of rays (coincident triangles
may tie across leaves) and t is bit-equal where it agrees. K4's any-hit
walk tests its leaves the same way, every lane latched: against its twin
and its first form by the same bars, and against K3's latch by occlusion on
>= 99.99% of rays (the two walks reach different first leaves, so their
slots differ).
"""
import numpy as np
import pytest
import torch

from tungsten_tpu_torch.ops import bvh, bvh2, bvh8, gather_bvh, intersect, intersect_stream

BAR = 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, n_tris=3000, n_rays=20000, seed=7):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2.0, 2.0, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    e2[::50] = e1[::50] * 2.0  # degenerate slots: all-zero planes
    tree = bvh8.tri_tree(v0, e1, e2)
    pack8 = bvh8.Bvh8Pack.from_arrays(bvh8.build_bvh_pack8(v0, e1, e2, tree), dev)
    packs = {"bvh8": pack8,
             "bvh3": bvh2.Bvh3Pack.from_arrays(bvh2.build_bvh_pack3(tree), pack8),
             "bvh": bvh.BvhPack.from_arrays(bvh.build_bvh_pack(v0, e1, e2, tree),
                                            len(tree.count), dev),
             "tri": intersect_stream.TriPack.from_arrays(
                 intersect_stream.build_tri_pack(v0, e1, e2), dev),
             "tri_soa": [torch.as_tensor(a, device=dev) for a in (v0, e1, e2)]}
    o = rng.uniform(-3.0, 3.0, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tfar = np.full(n_rays, 3.0e38)
    tfar[::9] = 0.0  # dead lanes
    tfar[5::9] = rng.uniform(0.5, 4.0, len(tfar[5::9]))
    rays = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (o, d, np.full(n_rays, 1e-4), tfar)]
    return packs, rays


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_kernel_matches_twin(cuda, mode):
    packs, (o, d, tn, tf) = _case(cuda)
    pack = packs["bvh8"]
    latch = {"closest": None, "any": True,
             "mixed": torch.arange(o.shape[0], device=cuda) % 2 == 0}[mode]
    k0 = bvh8.walk_cuda.launches
    tk, lk = bvh8.walk_cuda(pack, o, d, tn, tf, latch)
    torch.cuda.synchronize()
    assert bvh8.walk_cuda.launches == k0 + 1
    tt, lt = bvh8.walk_twin(pack, o, d, tn, tf, latch)
    same = (lk == lt).cpu().numpy()
    assert same.mean() >= BAR, f"{mode}: local agrees on {same.mean():.5f}"
    hit = same & (lk >= 0).cpu().numpy()
    assert 0.1 < hit.mean() < 0.9
    tk, tt = tk.cpu().numpy()[hit], tt.cpu().numpy()[hit]
    assert np.isclose(tk, tt, rtol=1e-5, atol=1e-6).mean() >= BAR
    np.testing.assert_allclose(tk, tt, rtol=1e-3)
    dead = (tf <= tn).cpu().numpy()
    assert (lk.cpu().numpy()[dead] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_kernel_matches_v1(cuda, mode):
    """The warp-cooperative K3 and its one-thread-per-ray form: the same
    (t, local), bit for bit."""
    packs, (o, d, tn, tf) = _case(cuda)
    pack = packs["bvh8"]
    latch = {"closest": None, "any": True,
             "mixed": torch.arange(o.shape[0], device=cuda) % 3 == 0}[mode]
    k0, v0 = bvh8.walk_cuda.launches, bvh8.walk_cuda_v1.launches
    tk, lk = bvh8.walk_cuda(pack, o, d, tn, tf, latch)
    tv, lv = bvh8.walk_cuda_v1(pack, o, d, tn, tf, latch)
    torch.cuda.synchronize()
    assert bvh8.walk_cuda.launches == k0 + 1 and bvh8.walk_cuda_v1.launches == v0 + 1
    assert 0.1 < (lk >= 0).float().mean().item() < 0.9
    assert torch.equal(lk, lv), f"{mode}: local agrees on {(lk == lv).float().mean().item():.6f}"
    assert torch.equal(tk.view(torch.int32), tv.view(torch.int32)), f"{mode}: t differs"


@pytest.mark.cuda
def test_fast_kernel_matches_twin(cuda):
    packs, (o, d, tn, tf) = _case(cuda)
    pack = packs["bvh8"]
    k0, t0 = bvh8.walk_fast_cuda.launches, bvh8.walk_fast_twin.launches
    tk, lk = bvh8.walk_fast(pack, o, d, tn, tf)
    torch.cuda.synchronize()
    assert bvh8.walk_fast_cuda.launches == k0 + 1 and bvh8.walk_fast_twin.launches == t0
    tt, lt = bvh8.walk_fast_twin(pack, o, d, tn, tf)
    assert 0.1 < (lk >= 0).float().mean().item() < 0.9
    same = (lk == lt).cpu().numpy()
    assert same.mean() >= BAR, f"slot agrees on {same.mean():.6f}"
    hit = same & (lk >= 0).cpu().numpy()
    tk_h, tt_h = tk.cpu().numpy()[hit], tt.cpu().numpy()[hit]
    assert np.isclose(tk_h, tt_h, rtol=1e-5, atol=1e-6).mean() >= BAR
    np.testing.assert_allclose(tk_h, tt_h, rtol=1e-3)
    assert (lk[tf <= tn] == -1).all()


@pytest.mark.cuda
def test_fast_kernel_v1_matches_twin(cuda):
    """The one-thread-per-ray fast walk (kept for comparison) adds in the
    twin's order: bit for bit."""
    packs, (o, d, tn, tf) = _case(cuda)
    pack = packs["bvh8"]
    tk, lk = bvh8.walk_fast_cuda_v1(pack, o, d, tn, tf)
    torch.cuda.synchronize()
    tt, lt = bvh8.walk_fast_twin(pack, o, d, tn, tf)
    assert torch.equal(lk, lt), f"slot agrees on {(lk == lt).float().mean().item():.6f}"
    assert torch.equal(tk, tt), f"t differs by up to {(tk - tt).abs().max().item():.3e}"


@pytest.mark.cuda
def test_fast_query_matches_exact_query(cuda):
    """Validate and repair on the card: the fast query's prim is the exact
    query's on >= 99.99% of rays, its t the exact recomputation's."""
    packs, (o, d, tn, tf) = _case(cuda)
    tris = intersect.TriangleSoA(*(packs["tri_soa"]))
    k_fast, k_exact = bvh8.walk_fast_cuda.launches, bvh8.walk_cuda.launches
    hf = bvh8.intersect(packs["bvh8"], tris, o, d, tn, tf)
    assert bvh8.walk_fast_cuda.launches == k_fast + 1 and bvh8.walk_cuda.launches == k_exact + 1
    he = bvh8.intersect(packs["bvh8"], tris, o, d, tn, tf, fast=False)
    same = hf.prim == he.prim
    assert same.float().mean().item() >= 0.9999
    hit = (same & (he.prim >= 0)).cpu().numpy()
    np.testing.assert_allclose(hf.t.cpu().numpy()[hit], he.t.cpu().numpy()[hit],
                               rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_walk_routes_cuda_tensors_to_the_kernel(cuda):
    packs, rays = _case(cuda, n_rays=512)
    k0, t0 = bvh8.walk_cuda.launches, bvh8.walk_twin.launches
    kept = (bvh8.walk_cuda_v1, bvh8.walk_fast_cuda_v1)
    before = [k.launches for k in kept]
    bvh8.walk(packs["bvh8"], *rays)
    assert bvh8.walk_cuda.launches == k0 + 1 and bvh8.walk_twin.launches == t0
    bvh8.intersect(packs["bvh8"], intersect.TriangleSoA(*packs["tri_soa"]), *rays)
    assert [k.launches for k in kept] == before


def _k4_k5(packs, walk):
    """(pack, kernel walk, twin walk, launch count) of K4 in one mode, of K5
    (v2: "packet", v1: "packet_v1") or of K2 ("stream")."""
    if walk == "stream":
        return (packs["tri"], intersect_stream.stream_cuda, intersect_stream.stream_twin,
                lambda: intersect_stream.stream_cuda.launches)
    if walk.startswith("packet"):
        prune = walk == "packet"
        kernel = lambda *a: bvh.walk_packet_cuda(*a, prune=prune)  # noqa: E731
        twin = lambda *a: bvh.walk_packet_twin(*a, prune=prune)  # noqa: E731
        return (packs["bvh"], kernel, twin,
                lambda: bvh.walk_packet_cuda.launches["v2" if prune else "v1"])
    kernel = lambda *a: bvh2.walk3_cuda(*a, mode=walk)  # noqa: E731
    twin = lambda *a: bvh2.walk3_twin(*a, mode=walk)  # noqa: E731
    return packs["bvh3"], kernel, twin, lambda: bvh2.walk3_cuda.launches[walk]


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["ordered", "skip", "any", "packet", "packet_v1", "stream"])
def test_k4_k5_kernels_match_twins(cuda, walk):
    packs, (o, d, tn, tf) = _case(cuda)
    pack, kernel, twin, count = _k4_k5(packs, walk)
    k0 = count()
    out_k = kernel(pack, o, d, tn, tf)
    torch.cuda.synchronize()
    assert count() == k0 + 1
    out_t = twin(pack, o, d, tn, tf)
    (tk, lk), (tt, lt) = out_k[:2], out_t[:2]
    same = (lk == lt).cpu().numpy()
    assert same.mean() >= BAR, f"{walk}: local agrees on {same.mean():.5f}"
    hit = same & (lk >= 0).cpu().numpy()
    assert 0.1 < hit.mean() < 0.9
    tk_h, tt_h = tk.cpu().numpy()[hit], tt.cpu().numpy()[hit]
    assert np.isclose(tk_h, tt_h, rtol=1e-5, atol=1e-6).mean() >= BAR
    np.testing.assert_allclose(tk_h, tt_h, rtol=1e-3)
    for a, b in zip(out_k[2:], out_t[2:]):  # K5's and K2's u and v
        a, b = a.cpu().numpy()[hit], b.cpu().numpy()[hit]
        assert np.isclose(a, b, rtol=0, atol=1e-5).mean() >= BAR
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    dead = (tf <= tn).cpu().numpy()
    assert (lk.cpu().numpy()[dead] == -1).all()


def _same_bits(a, b):
    """Two (t, slot or prim, u, v) results equal bit for bit."""
    return all(torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
               for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("prune", [True, False], ids=["v2", "v1"])
def test_k5_kernel_bit_equal_to_twin_and_first_form(cuda, prune):
    """The warp-cooperative K5 in both modes: (t, local, u, v) bit for bit
    its twin's and its first CUDA form's (bvh_walk_v1.cu)."""
    packs, rays = _case(cuda)
    pack = packs["bvh"]
    version = "v2" if prune else "v1"
    k0, v0 = bvh.walk_packet_cuda.launches[version], bvh.walk_packet_cuda_v1.launches[version]
    new = bvh.walk_packet_cuda(pack, *rays, prune=prune)
    old = bvh.walk_packet_cuda_v1(pack, *rays, prune=prune)
    torch.cuda.synchronize()
    assert bvh.walk_packet_cuda.launches[version] == k0 + 1
    assert bvh.walk_packet_cuda_v1.launches[version] == v0 + 1
    twin = bvh.walk_packet_twin(pack, *rays, prune=prune)
    assert 0.1 < (new[1] >= 0).float().mean().item() < 0.9
    assert _same_bits(new, twin), f"slot agrees on {(new[1] == twin[1]).float().mean().item():.6f}"
    assert _same_bits(new, old)


@pytest.mark.cuda
def test_k2_kernel_against_twin_and_first_form(cuda):
    """The per-warp, per-sub-box K2 against its twin: prim on >= 99.99% of
    rays, and where it agrees t, u, v bit for bit; its first CUDA form
    (intersect_stream_v1.cu) equals the twin bit for bit."""
    packs, rays = _case(cuda)
    pack = packs["tri"]
    k0, v0 = intersect_stream.stream_cuda.launches, intersect_stream.stream_cuda_v1.launches
    new = intersect_stream.stream_cuda(pack, *rays)
    old = intersect_stream.stream_cuda_v1(pack, *rays)
    torch.cuda.synchronize()
    assert intersect_stream.stream_cuda.launches == k0 + 1
    assert intersect_stream.stream_cuda_v1.launches == v0 + 1
    twin = intersect_stream.stream_twin(pack, *rays)
    assert _same_bits(old, twin), f"v1 prim agrees on {(old[1] == twin[1]).float().mean().item():.6f}"
    same = new[1] == twin[1]
    assert same.float().mean().item() >= 0.9999, f"prim agrees on {same.float().mean().item():.6f}"
    assert 0.1 < (new[1] >= 0).float().mean().item() < 0.9
    for x, y in zip(new[0:1] + new[2:], twin[0:1] + twin[2:]):
        assert torch.equal(x[same].view(torch.int32), y[same].view(torch.int32))
    dead = rays[3] <= rays[2]
    assert (new[1][dead] == -1).all()


@pytest.mark.cuda
def test_k4_k5_walks_route_cuda_tensors_to_the_kernels(cuda):
    packs, rays = _case(cuda, n_rays=512)
    def counts():
        return (*bvh2.walk3_cuda.launches.values(), sum(bvh2.walk3_twin.launches.values()),
                *bvh.walk_packet_cuda.launches.values(),
                sum(bvh.walk_packet_twin.launches.values()),
                intersect_stream.stream_cuda.launches, intersect_stream.stream_twin.launches,
                sum(bvh.walk_packet_cuda_v1.launches.values()),
                intersect_stream.stream_cuda_v1.launches,
                sum(bvh2.walk3_cuda_v1.launches.values()))

    before = counts()
    for mode in bvh2.MODES:
        bvh2.walk3(packs["bvh3"], *rays, mode)
    bvh.walk_packet(packs["bvh"], *rays)
    bvh.walk_packet(packs["bvh"], *rays, prune=False)
    intersect_stream.stream(packs["tri"], *rays)
    bvh.intersect_bvh(packs["bvh"], *rays)
    intersect_stream.intersect_stream(packs["tri"], *rays)
    assert [b - a for a, b in zip(before, counts())] == [1, 1, 1, 0, 1, 2, 0, 2, 0, 0, 0, 0]


def _k4_bars(label, out, ref):
    """A K4 walk against a reference by the file's bars (slot, then t)."""
    (tk, lk), (tr, lr) = out, ref
    same = (lk == lr).cpu().numpy()
    assert same.mean() >= BAR, f"{label}: local agrees on {same.mean():.5f}"
    hit = same & (lk >= 0).cpu().numpy()
    assert 0.1 < hit.mean() < 0.9
    tk_h, tr_h = tk.cpu().numpy()[hit], tr.cpu().numpy()[hit]
    assert np.isclose(tk_h, tr_h, rtol=1e-5, atol=1e-6).mean() >= BAR, label
    np.testing.assert_allclose(tk_h, tr_h, rtol=1e-3, err_msg=label)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", bvh2.MODES)
def test_k4_kernel_against_twin_first_form_and_k3(cuda, mode):
    """The warp-cooperative K4 walk against its twin and its first CUDA form
    (bvh2_walk_v1.cu) by the bars, and against exact K3 on the same rays:
    the closest-hit walks by slot on >= 99.99%, t bit for bit where it
    agrees; "any" against K3's latch by occlusion on >= 99.99% (the BVH8
    walk reaches another first leaf, so the slots differ). Every hit lies
    in (tnear, tfar); dead lanes miss."""
    packs, rays = _case(cuda)
    pack = packs["bvh3"]
    k0, v0 = bvh2.walk3_cuda.launches[mode], bvh2.walk3_cuda_v1.launches[mode]
    new = bvh2.walk3_cuda(pack, *rays, mode)
    old = bvh2.walk3_cuda_v1(pack, *rays, mode)
    torch.cuda.synchronize()
    assert bvh2.walk3_cuda.launches[mode] == k0 + 1
    assert bvh2.walk3_cuda_v1.launches[mode] == v0 + 1
    _k4_bars(f"{mode} vs twin", new, bvh2.walk3_twin(pack, *rays, mode))
    _k4_bars(f"{mode} vs v1", new, old)
    if mode == "any":
        _, l3 = bvh8.walk_cuda(packs["bvh8"], *rays, latch=True)
        occ = ((new[1] >= 0) == (l3 >= 0)).float().mean().item()
        assert occ >= 0.9999, f"any vs K3's latch: occlusion agrees on {occ:.6f}"
    else:
        t3, l3 = bvh8.walk_cuda(packs["bvh8"], *rays)
        same = new[1] == l3
        agree = same.float().mean().item()
        assert agree >= 0.9999, f"{mode} vs K3: slot agrees on {agree:.6f}"
        assert torch.equal(new[0][same].view(torch.int32), t3[same].view(torch.int32))
    hit = new[1] >= 0
    assert bool(((new[0][hit] > rays[2][hit]) & (new[0][hit] < rays[3][hit])).all())
    assert (new[1][rays[3] <= rays[2]] == -1).all()


@pytest.mark.cuda
def test_small_interior_on_the_card_matches_reference(cuda, tmp_path):
    """`small-interior` (the interior cell's surfaces: dielectric, rough
    dielectric, plastic, rough plastic with textured roughness, conductor,
    mirror, a null-BSDF light fixture, an .hdr sky) rendered on the card in
    both wavefronts, on the numpy BVH build, against the JAX package's
    channel means in tests/data/torch_port_interior_ref.json within 5e-3;
    the render's walks go through K3 and K3-fast, no twin."""
    import json
    import os

    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.accel import bvh as accel_bvh
    from tungsten_tpu_torch.renderer.render import render_scene

    with open(os.path.join(os.path.dirname(__file__), "data",
                           "torch_port_interior_ref.json")) as f:
        ref = json.load(f)
    path = synth.write_scene(str(tmp_path), "small-interior")
    native, accel_bvh._NATIVE = accel_bvh._NATIVE, False
    try:
        for wavefront in ("regen", "lockstep"):
            k3, fast = bvh8.walk_cuda.launches, bvh8.walk_fast_cuda.launches
            twins = bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches
            hdr, _ = render_scene(path, torch.device("cuda"), seed=ref["seed"],
                                  wavefront=wavefront)
            assert bvh8.walk_cuda.launches > k3 and bvh8.walk_fast_cuda.launches > fast
            assert bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches == twins
            assert np.isfinite(hdr).all() and (hdr >= 0).all()
            means = hdr.reshape(-1, 3).astype(np.float64).mean(0)
            np.testing.assert_allclose(means, ref["channel_means"][wavefront], rtol=5e-3,
                                       err_msg=wavefront)
    finally:
        accel_bvh._NATIVE = native


@pytest.mark.cuda
@pytest.mark.parametrize("size,ref_file", [("small-coat", "torch_port_coat_ref.json"),
                                           ("small-cutout", "torch_port_cutout_ref.json")])
def test_surface_scenes_on_the_card_match_reference(cuda, tmp_path, size, ref_file):
    """`small-coat` (smooth_coat, rough_coat, mixed, oren_nayar, phong,
    diffuse_transmission; both wavefronts) and `small-cutout`
    (transparency, thinsheet, forward: lockstep's crossing-walk branch)
    rendered on the card, on the numpy BVH build, against the JAX package's
    channel means in tests/data within 5e-3, each wavefront the reference
    holds; the walks go through K3 and K3-fast, no twin."""
    import json
    import os

    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.accel import bvh as accel_bvh
    from tungsten_tpu_torch.renderer.render import render_scene

    with open(os.path.join(os.path.dirname(__file__), "data", ref_file)) as f:
        ref = json.load(f)
    path = synth.write_scene(str(tmp_path), size)
    native, accel_bvh._NATIVE = accel_bvh._NATIVE, False
    try:
        for wavefront, want in ref["channel_means"].items():
            k3, fast = bvh8.walk_cuda.launches, bvh8.walk_fast_cuda.launches
            twins = bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches
            hdr, _ = render_scene(path, torch.device("cuda"), seed=ref["seed"],
                                  wavefront=wavefront)
            assert bvh8.walk_cuda.launches > k3 and bvh8.walk_fast_cuda.launches > fast
            assert bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches == twins
            assert np.isfinite(hdr).all() and (hdr >= 0).all()
            means = hdr.reshape(-1, 3).astype(np.float64).mean(0)
            np.testing.assert_allclose(means, want, rtol=5e-3, err_msg=wavefront)
    finally:
        accel_bvh._NATIVE = native


def _k1_case(dev):
    """The K1 pack of _case's scene (its own 8-ary tree) and _case's rays."""
    packs, rays = _case(dev)
    v0, e1, e2 = (x.cpu().numpy() for x in packs["tri_soa"])
    pack = gather_bvh.GatherBvhPack.from_arrays(gather_bvh.build_gather_pack(v0, e1, e2), dev)
    return packs, pack, rays


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_k1_kernel_bit_equal_to_twin(cuda, mode):
    """K1 (gather_walk.cu) rounds every operation as its twin does: t, prim,
    u and v equal bit for bit, in closest, latched and mixed mode; dead
    lanes miss; the launch counts move by one each."""
    _, pack, (o, d, tn, tf) = _k1_case(cuda)
    latch = {"closest": None, "any": True,
             "mixed": torch.arange(o.shape[0], device=cuda) % 2 == 0}[mode]
    k0, t0 = gather_bvh.walk_cuda.launches, gather_bvh.walk_twin.launches
    out = gather_bvh.walk_cuda(pack, o, d, tn, tf, latch)
    torch.cuda.synchronize()
    twin = gather_bvh.walk_twin(pack, o, d, tn, tf, latch)
    assert gather_bvh.walk_cuda.launches == k0 + 1 and gather_bvh.walk_twin.launches == t0 + 1
    assert _same_bits(out, twin), f"{mode}: prim agrees on {(out[1] == twin[1]).float().mean()}"
    hit = (out[1] >= 0).float().mean().item()
    assert 0.1 < hit < 0.9
    assert bool((out[1][tf <= tn] == -1).all())


@pytest.mark.cuda
def test_k1_queries_against_brute_force(cuda):
    """K1's closest-hit query against intersect_brute: prim on >= 99.9% of
    the rays, t within rtol 1e-5 where it agrees; its any-hit query against
    the brute-force hit mask on >= 99.9%; `walk` sends CUDA tensors to the
    kernel."""
    packs, pack, rays = _k1_case(cuda)
    o, d, tn, tf = (x[:4096] for x in rays)
    tris = intersect.TriangleSoA(*packs["tri_soa"])
    hb = intersect.intersect_brute(tris, o, d, tn, tf)
    k0, t0 = gather_bvh.walk_cuda.launches, gather_bvh.walk_twin.launches
    hk = gather_bvh.intersect_bvh_gather(pack, o, d, tn, tf)
    occ = gather_bvh.occluded_bvh_gather(pack, o, d, tn, tf)
    assert gather_bvh.walk_cuda.launches == k0 + 2 and gather_bvh.walk_twin.launches == t0
    same = hk.prim == hb.prim
    assert same.float().mean().item() >= BAR
    both = same & (hb.prim >= 0)
    torch.testing.assert_close(hk.t[both], hb.t[both], rtol=1e-5, atol=1e-6)
    assert (occ == (hb.prim >= 0)).float().mean().item() >= BAR


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tau", "inverse"])
@pytest.mark.parametrize("linear", [True, False])
def test_k6_grid_walk_bit_equal_to_twin(cuda, mode, linear):
    """K6 (grid_walk.cu) rounds every operation as its twin does: the
    optical depth and the inverse's t equal bit for bit, INF lanes equal,
    masked-out lanes 0 (tau) or INF; the launch counts move by one each; a
    CUDA tensor goes to the kernel through grid_optical_depth, and a CPU
    density with CUDA rays raises."""
    from tungsten_tpu_torch.models.grids import grid as tg
    from tungsten_tpu_torch.ops import grid_walk

    rng = np.random.default_rng(13)
    n = 8192
    dens = rng.uniform(0.0, 2.0, (24, 20, 28)).astype(np.float32)
    g = tg.DenseGrid.from_arrays(
        {"density": dens, "emission": np.zeros((1, 1, 1, 3), np.float32),
         "w2g": np.array([[20.0, 0, 0, 14.0], [0, 20.0, 0, 10.0], [0, 0, 20.0, 12.0]],
                         np.float32), "g2w_scale": np.float32(0.05)},
        {"dims": (28, 20, 24), "steps": 96, "linear": linear, "has_emission": False,
         "exact": True}, cuda)
    o = torch.tensor(rng.uniform(-1.2, 1.2, (n, 3)), dtype=torch.float32, device=cuda)
    aim = torch.tensor(rng.uniform(-0.4, 0.4, (n, 3)), dtype=torch.float32, device=cuda)
    d = aim - o  # most rays cross the grid, some from inside it
    d[::97, 1] = 0.0  # lanes parallel to a grid plane
    d = d / d.norm(dim=1, keepdim=True)
    t0 = torch.zeros(n, device=cuda)
    t1 = torch.tensor(rng.uniform(0.5, 3.0, n), dtype=torch.float32, device=cuda)
    oq, dq, ta, tb = tg._walk_inputs(g, o, d, t0, t1)
    mask = torch.arange(n, device=cuda) % 5 != 0
    target = None
    if mode == "inverse":
        full = grid_walk.walk_twin(g.density, linear, oq, dq, ta, tb)
        target = (full * torch.tensor(rng.uniform(0.1, 1.3, n), dtype=torch.float32,
                                      device=cuda)).contiguous()
    k0, w0 = grid_walk.walk_cuda.launches, grid_walk.walk_twin.launches
    out = grid_walk.walk_cuda(g.density, linear, oq, dq, ta, tb, mode, target, mask)
    torch.cuda.synchronize()
    twin = grid_walk.walk_twin(g.density, linear, oq, dq, ta, tb, mode, target, mask)
    assert grid_walk.walk_cuda.launches == k0 + 1 and grid_walk.walk_twin.launches == w0 + 1
    assert torch.equal(out, twin), f"{(out != twin).sum().item()} lanes differ"
    assert grid_walk.walk_twin.work["rounds"] > n
    if mode == "tau":
        assert (out[~mask] == 0).all() and (out[mask] > 0).float().mean() > 0.3
    else:
        assert (out[~mask] >= 1e30).all() and 0 < (out[mask] >= 1e30).sum() < mask.sum()
    k1 = grid_walk.walk_cuda.launches
    tg.grid_optical_depth(g, o, d, t0, t1)
    assert grid_walk.walk_cuda.launches == k1 + 1
    with pytest.raises(ValueError):
        grid_walk.walk_cuda(g.density.cpu(), linear, oq, dq, ta, tb)


@pytest.mark.cuda
def test_light_tracer_and_bdpt_on_the_card_match_reference(cuda, tmp_path):
    """`small-box` (a closed box, one emissive quad) through the light
    tracer and BDPT on the card, on the numpy BVH build, against the JAX
    package's channel means in tests/data/torch_port_bdpt_ref.json within
    5e-3; the walks go through K3 and K3-fast, no twin."""
    import json
    import os

    from tungsten_tpu_torch import synth
    from tungsten_tpu_torch.accel import bvh as accel_bvh
    from tungsten_tpu_torch.renderer.render import render_bdpt, render_light_traced
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    with open(os.path.join(os.path.dirname(__file__), "data", "torch_port_bdpt_ref.json")) as f:
        ref = json.load(f)
    native, accel_bvh._NATIVE = accel_bvh._NATIVE, False
    try:
        scene = flatten_scene(load_scene(synth.write_scene(str(tmp_path), "small-box")), cuda)
    finally:
        accel_bvh._NATIVE = native
    for name, render in (("lt", render_light_traced), ("bdpt", render_bdpt)):
        k3, fast = bvh8.walk_cuda.launches, bvh8.walk_fast_cuda.launches
        twins = bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches
        img = render(scene, seed=ref["seed"])
        assert bvh8.walk_cuda.launches > k3 and bvh8.walk_fast_cuda.launches > fast
        assert bvh8.walk_twin.launches + bvh8.walk_fast_twin.launches == twins
        assert np.isfinite(img).all() and (img >= 0).all()
        np.testing.assert_allclose(img.reshape(-1, 3).astype(np.float64).mean(0),
                                   ref["channel_means"]["small-box"][name], rtol=5e-3,
                                   err_msg=name)


def _photon_case(dev, mode, n=4096, seed=9):
    """A crowded photon grid (pack rows as build_photon_grid and
    build_beam_grid lay them out) and lanes over it, on `dev`."""
    from tungsten_tpu_torch.integrators.photon_map import build_beam_grid, build_photon_grid

    rng = np.random.default_rng(seed)
    m = 20000
    centre = rng.integers(-4, 4, (16, 3)).astype(np.float32)
    pos = (centre[rng.integers(0, 16, m)] + rng.random((m, 3)).astype(np.float32)) * 0.4
    if mode == "beams":
        bd = rng.normal(size=(m, 3)).astype(np.float32)
        bd /= np.linalg.norm(bd, axis=-1, keepdims=True)
        grid = build_beam_grid(*(torch.as_tensor(a, device=dev) for a in (
            pos.astype(np.float32), bd.astype(np.float32),
            rng.uniform(0.0, 2.0, m).astype(np.float32), rng.random((m, 3)).astype(np.float32),
            np.zeros(m, np.int32), rng.random(m) < 0.9, rng.integers(1, 6, m).astype(np.int32))),
            0.2)[:3]
    else:
        grid = build_photon_grid(*(torch.as_tensor(a, device=dev) for a in (
            pos.astype(np.float32), rng.random((m, 3)).astype(np.float32),
            rng.normal(size=(m, 3)).astype(np.float32), rng.random(m) < 0.9)),
            0.4, bounce=torch.as_tensor(rng.integers(1, 6, m).astype(np.int32), device=dev))[:3]
    o = (pos[rng.integers(0, m, n)] + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lim = (rng.uniform(0.0, 4.0, n) if mode in ("points", "beams")
           else np.full(n, 0.16 if mode == "hist" else 0.1)).astype(np.float32)
    lanes = [torch.as_tensor(a, device=dev) for a in (
        o, d.astype(np.float32), lim, rng.integers(1, 4, n).astype(np.int32), rng.random(n) < 0.9)]
    if mode not in ("points", "beams"):
        lanes[1] = None
    return grid, lanes, 0.4, 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["surface", "hist", "points", "beams"])
def test_k7_photon_walk_bit_equal_to_twin(cuda, mode):
    """K7 (photon_walk.cu) rounds every operation as its twin does: the
    pairs (lane, row) in (lane, round, offset, slot) order, their floats and
    the kNN histogram equal the twin's bit for bit; `walk` sends CUDA lanes
    to the kernel (two or three launches a call) and refuses CPU grids."""
    from tungsten_tpu_torch.ops import photon_walk

    grid, lanes, cell, r = _photon_case(cuda, mode)
    args = (mode, *grid, *lanes, cell, r, 0, 6)
    k0, w0 = photon_walk.walk_cuda.launches, photon_walk.walk_twin.launches
    out = photon_walk.walk(*args)
    torch.cuda.synchronize()
    twin = photon_walk.walk_twin(*args)
    work = photon_walk.walk_twin.work
    assert photon_walk.walk_twin.launches == w0 + 1
    assert photon_walk.walk_cuda.launches - k0 == {"hist": 1, "surface": 2}.get(mode, 3)
    if mode == "hist":
        assert torch.equal(out, twin) and int(twin.sum()) > 1000
        return
    assert work["pairs"] > 1000 and len(out) == len(twin)
    for a, b in zip(out, twin):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    with pytest.raises(ValueError):
        photon_walk.walk_cuda(mode, grid[0].cpu(), *grid[1:], *lanes, cell, r, 0, 6)
