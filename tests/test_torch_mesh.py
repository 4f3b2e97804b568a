"""The sharded renders (tungsten_tpu_torch/parallel/mesh.py) on the CPU.

The mirror of tests/test_multichip.py for the port: one process a device
under torch.distributed, here gloo ranks on the CPU spawned with
parallel/mesh.py's start_ranks (torch.multiprocessing's spawn context, a
file:// store under tmp_path). One spawn a world size (2 and 3) renders
every sharded integrator in the ranks; the parent holds each image to the
port's one-process render by the bars of tests/test_multichip.py: the
lockstep path tracer bit for bit, the light tracer and BDPT at rtol 1e-5 /
atol 1e-6, SPPM and the Metropolis renders at rtol 1e-4 / atol 1e-5.
Kelemen and MMLT run a second time with as many chains as pixels, where
the splat buffer has n_chains rows. The 2-rank path-traced image is also
held to the JAX package's 2-device mesh render at the port's 2e-3 relative
per-channel-mean bar. The 2-rank spawn also writes resume states that a
one-process render continues, and checks that `replicate` refuses ranks
whose scenes differ.

The scenes are `small` (path tracer, env light) and `small-box` (the other
integrators take no env light, ROADMAP §3), with its fog for SPPM's
volume photons, beams and planes, cut to 32x24 and 3 bounces so that the
file stays near a minute. Every rank runs one torch thread, and
every wait on a rank has a deadline: a rank that fails or hangs fails the
test with its traceback.
"""
import json
import os

import numpy as np
import pytest
import torch

RES = (32, 24)
BOUNCES = 3
WORLDS = (2, 3)
DEADLINE = 300.0  # seconds for a whole spawn
MLT = dict(seed=17, n_chains=1 << 9, bootstrap_factor=2)
# as many chains as pixels: the (W * H, 3) splat buffer has n_chains rows
MLT_PIXELS = dict(MLT, n_chains=RES[0] * RES[1])
BARS = {"pt": None, "lt": (1e-5, 1e-6), "bdpt": (1e-5, 1e-6), "sppm": (1e-4, 1e-5),
        "sppm_fog_points": (1e-4, 1e-5), "sppm_fog_planes": (1e-4, 1e-5),
        "kelemen": (1e-4, 1e-5), "kelemen_bdpt": (1e-4, 1e-5), "mmlt": (1e-4, 1e-5),
        "rjmlt": (1e-4, 1e-5), "kelemen_chain_per_pixel": (1e-4, 1e-5),
        "mmlt_chain_per_pixel": (1e-4, 1e-5)}


def write_scenes(out_dir):
    """small, small-box and small-box's fog (its volume photons, beams and
    planes), cut to RES and BOUNCES: {name: scene.json}."""
    from tungsten_tpu_torch import synth

    paths = {}
    for name, size, variant in (("small", "small", None), ("small-box", "small-box", None),
                                ("fog", "small-box", "progressive_photon_map+fog+planes")):
        path = synth.write_scene(os.path.join(out_dir, name), size, variant)
        with open(path) as f:
            doc = json.load(f)
        doc["camera"]["resolution"] = list(RES)
        doc["integrator"]["max_bounces"] = BOUNCES
        with open(path, "w") as f:
            json.dump(doc, f)
        paths[name] = path
    return paths


def flatten(path):
    import tungsten_tpu_torch.accel.bvh as tbvh
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.load import load_scene

    tbvh._NATIVE = False  # the numpy build, as every parity test of the port
    return flatten_scene(load_scene(path), torch.device("cpu"))


def render_all(paths, mesh=None):
    """Every sharded integrator's image: {name: (H, W, 3)}."""
    from tungsten_tpu_torch.integrators import kelemen, multiplexed, rjmlt
    from tungsten_tpu_torch.renderer import render as R

    pt, box, fog = (flatten(paths[k]) for k in ("small", "small-box", "fog"))
    fog_kw = dict(spp=1, seed=13, photons_per_iter=1 << 10, mesh=mesh)
    return {
        "pt": R.render_flat(pt, spp=2, mesh=mesh, wavefront="lockstep"),
        "lt": R.render_light_traced(box, spp=2, seed=9, mesh=mesh),
        "bdpt": R.render_bdpt(box, spp=1, seed=11, mesh=mesh),
        "sppm": R.render_sppm(box, spp=2, seed=13, photons_per_iter=1 << 12, mesh=mesh),
        "sppm_fog_points": R.render_sppm(fog, volume_photon_type="points", **fog_kw),
        "sppm_fog_planes": R.render_sppm(fog, volume_photon_type="planes", **fog_kw),
        "kelemen": kelemen.render_kelemen(box, spp=1, mesh=mesh, **MLT),
        "kelemen_bdpt": kelemen.render_kelemen_bdpt(box, spp=1, mesh=mesh, **MLT),
        "mmlt": multiplexed.render_mmlt(box, spp=1, mesh=mesh, **MLT),
        "rjmlt": rjmlt.render_rjmlt(box, spp=1, mesh=mesh, **MLT),
        "kelemen_chain_per_pixel": kelemen.render_kelemen(box, spp=1, mesh=mesh, **MLT_PIXELS),
        "mmlt_chain_per_pixel": multiplexed.render_mmlt(box, spp=1, mesh=mesh, **MLT_PIXELS),
    }


def resume_states(paths, mesh, out_dir):
    """Half renders under the mesh that save their states (rank 0 writes):
    the lockstep framebuffer at 1 of 2 spp, the Kelemen chains at 1 of 2."""
    from tungsten_tpu_torch.integrators import kelemen
    from tungsten_tpu_torch.renderer import render as R

    R.render_buffers(flatten(paths["small"]), spp=1, mesh=mesh, wavefront="lockstep",
                     resume_file=os.path.join(out_dir, "pt_state.npz"))
    kelemen.render_kelemen(flatten(paths["small-box"]), spp=1, mesh=mesh,
                           resume_file=os.path.join(out_dir, "mlt_state.npz"), **MLT)


def refused(paths, mesh):
    """replicate on ranks whose scenes differ (rank 1's normals moved):
    the message every rank raises, or None where none was raised."""
    import dataclasses

    from tungsten_tpu_torch.parallel.mesh import rank, replicate

    scene = flatten(paths["small"])
    if rank(mesh) == 1:
        scene = dataclasses.replace(scene, tri_ng=scene.tri_ng + 1.0)
    try:
        replicate(mesh, scene)
    except RuntimeError as e:
        return str(e)
    return None


def rank_main(mesh, paths, out_dir):
    """One gloo rank: every sharded render (and, in the 2-rank world, the
    resume states and the refusal)."""
    from tungsten_tpu_torch.parallel.mesh import size

    out = {"images": render_all(paths, mesh)}
    if size(mesh) == 2:
        resume_states(paths, mesh, out_dir)
        out["refused"] = refused(paths, mesh)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while the module runs (as
    test_torch_lockstep_area.one_torch_thread, which this module does not
    import: the ranks import this module, and that one imports jax)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns' results and the one-process renders."""
    import time

    from tungsten_tpu_torch.parallel.mesh import join_ranks, start_ranks

    root = tmp_path_factory.mktemp("mesh")
    paths = write_scenes(str(root))
    started = {}
    for world in WORLDS:
        out_dir = str(root / f"w{world}")
        os.makedirs(out_dir)
        ranks = start_ranks(rank_main, world, (paths, out_dir), device_type="cpu",
                            backend="gloo", init_method=f"file://{out_dir}/store",
                            timeout=DEADLINE, threads=1)
        started[world] = (ranks, out_dir)
    single = render_all(paths)  # while the ranks render
    deadline = time.time() + DEADLINE
    results = {world: (join_ranks(ranks, deadline), out_dir)
               for world, (ranks, out_dir) in started.items()}
    return paths, single, results


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(BARS))
def test_sharded_render_matches_one_process(runs, world, name):
    _, single, results = runs
    got, _ = results[world]
    ref = single[name]
    for rank in range(world):  # every rank returns the whole image
        img = got[rank]["images"][name]
        assert img.shape == ref.shape == (RES[1], RES[0], 3)
        assert np.isfinite(img).all() and img.max() > 0.0
        if BARS[name] is None:
            assert np.array_equal(img, ref), (
                f"{world} ranks: lockstep PT differs from one process, max abs diff "
                f"{np.abs(img - ref).max()}")
        else:
            rtol, atol = BARS[name]
            np.testing.assert_allclose(img, ref, rtol=rtol, atol=atol)


def test_two_ranks_match_the_jax_mesh_render(runs):
    """The 2-rank image against JAX render_flat over a 2-device mesh: the
    per-channel means within 2e-3 relative (ROADMAP's bar on the CPU)."""
    import jax
    import tungsten_tpu.accel.bvh as jbvh
    from tungsten_tpu.parallel.mesh import make_mesh
    from tungsten_tpu.renderer.render import render_flat
    from tungsten_tpu.scene.flatten import flatten_scene
    from tungsten_tpu.scene.load import load_scene

    paths, _, results = runs
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", False)
    try:
        jscene = flatten_scene(load_scene(paths["small"]))
        ref = np.asarray(render_flat(jscene, spp=2, mesh=make_mesh(jax.devices()[:2])))
    finally:
        mp.undo()
    img = results[2][0][0]["images"]["pt"]
    assert ref.shape == img.shape
    np.testing.assert_allclose(img.reshape(-1, 3).mean(0), ref.reshape(-1, 3).mean(0),
                               rtol=2e-3)


def test_framebuffer_state_resumes_in_one_process(runs):
    """A state the 2-rank render wrote at 1 spp, continued to 2 spp in one
    process, equals a straight one-process render bit for bit; its extra
    carries res for the denoiser."""
    from tungsten_tpu_torch.renderer import render as R

    paths, single, results = runs
    state = os.path.join(results[2][1], "pt_state.npz")
    with np.load(state) as z:
        header = json.loads(bytes(z["__header__"]).decode())
    assert header["extra"] == {"next_pass": 1, "res": list(RES)}
    img = R.render_buffers(flatten(paths["small"]), spp=2, wavefront="lockstep",
                           resume_file=state).color()
    assert np.array_equal(img, single["pt"])


def test_chain_state_resumes_in_one_process(runs):
    """Kelemen chains the 2-rank render saved after 1 spp, continued to 2
    spp in one process, against a straight 2-spp render (rtol 1e-4)."""
    from tungsten_tpu_torch.integrators import kelemen

    paths, _, results = runs
    box = flatten(paths["small-box"])
    state = os.path.join(results[2][1], "mlt_state.npz")
    resumed = kelemen.render_kelemen(box, spp=2, resume_file=state, **MLT)
    straight = kelemen.render_kelemen(box, spp=2, **MLT)
    assert resumed.max() > 0.0
    np.testing.assert_allclose(resumed, straight, rtol=1e-4, atol=1e-5)


def test_replicate_refuses_different_scenes(runs):
    _, _, results = runs
    for rank, out in results[2][0].items():
        assert out["refused"] is not None, f"rank {rank} did not refuse"
        assert "rank(s) [1] differs from rank 0" in out["refused"]


class FakeMesh:
    """Rank r of an n-rank CPU mesh, for the functions that only ask a mesh
    its size and rank."""

    def __init__(self, r, n):
        self.r, self.n, self.device_type = r, n, "cpu"

    def size(self):
        return self.n

    def get_local_rank(self, axis):
        return self.r


def test_lane_blocks_cover_the_lanes_in_order():
    """shard_lanes' blocks over ranks 0..n-1 concatenate to the lanes, the
    short ones last; pad_to_devices rounds up."""
    from tungsten_tpu_torch.parallel import mesh as pm

    Fake = FakeMesh
    lanes = torch.arange(10)
    for n in (1, 2, 3, 4, 7, 16):
        blocks = [pm.shard_lanes(Fake(r, n), lanes) for r in range(n)]
        assert torch.equal(torch.cat(blocks), lanes)
        sizes = [b.shape[0] for b in blocks]
        assert sizes == sorted(sizes, reverse=True)
    assert pm.pad_to_devices(10, 3) == 12 and pm.pad_to_devices(12, 3) == 12


@pytest.mark.parametrize("n_chains", [6, 12])
def test_chain_state_is_split_by_key(n_chains):
    """shard_chain_state cuts every per-chain tensor to the rank's block and
    keeps the splat buffer whole (zeros past rank 0), also where the buffer
    has n_chains rows (12 pixels, 12 chains)."""
    from tungsten_tpu_torch.parallel import mesh as pm

    g = torch.Generator().manual_seed(3)
    state = {"table": torch.rand((n_chains, 4, 2), generator=g),
             "lum": torch.rand((n_chains,), generator=g),
             "splat": torch.rand((12, 3), generator=g)}
    parts = [pm.shard_chain_state(FakeMesh(r, 3), state, n_chains) for r in range(3)]
    for k in ("table", "lum"):
        assert torch.equal(torch.cat([p[k] for p in parts]), state[k])
    assert torch.equal(parts[0]["splat"], state["splat"])
    assert all(p["splat"].shape == (12, 3) and not p["splat"].any() for p in parts[1:])


def test_no_mesh_is_one_process():
    """mesh=None: every function hands its input back, rank 0 of 1."""
    from tungsten_tpu_torch.parallel import mesh as pm

    x, y = torch.arange(5.0), torch.arange(5)
    state = {"lum": x, "splat": torch.ones(4, 3)}
    scene = object()
    assert pm.rank(None) == 0 and pm.size(None) == 1
    assert pm.shard_lanes(None, x) is x
    assert all(a is b for a, b in zip(pm.shard_lanes(None, x, y), (x, y)))
    assert pm.all_gather_lanes(None, x, 5) is x and pm.all_reduce_sum(None, x) is x
    assert pm.shard_chain_state(None, state, 5) is state
    assert pm.gather_chain_state(None, state, 5) is state
    assert pm.replicate(None, scene) is scene
    pm.barrier(None)


def test_scene_digest_is_kept_on_the_scene(tmp_path):
    """The digest is computed once per scene object; a replaced scene (a
    new object) is hashed anew and differs."""
    import dataclasses

    from tungsten_tpu_torch.parallel.mesh import scene_digest

    paths = write_scenes(str(tmp_path))
    scene = flatten(paths["small"])
    d = scene_digest(scene)
    assert scene._mesh_digest == d and scene_digest(scene) is d
    assert scene_digest(flatten(paths["small"])) == d
    moved = dataclasses.replace(scene, tri_ng=scene.tri_ng + 1.0)
    assert getattr(moved, "_mesh_digest", None) is None and scene_digest(moved) != d
