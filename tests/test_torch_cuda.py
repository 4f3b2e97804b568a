"""The port's CUDA kernel against its plain twin, on a card.

These tests need a CUDA card and nvcc; without a card they skip. The file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bars: local slot (prim) agrees on >= 99.9% of rays. Where it agrees, t is
within rtol 1e-5 plus 1e-6 absolute on >= 99.9% of hits and within rtol 1e-3
on all: the plane form's numerator cancels to the point-plane distance, so
its rounding error is absolute (~eps * |o|) and grows as 1 / |cos| on
grazing hits, and the kernel fuses multiply-adds where the twin does not.
"""
import numpy as np
import pytest
import torch

from tungsten_tpu_torch.ops import bvh8

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
    pack = bvh8.Bvh8Pack.from_arrays(bvh8.build_bvh_pack8(v0, e1, e2), dev)
    o = rng.uniform(-3.0, 3.0, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tfar = np.full(n_rays, 3.0e38)
    tfar[::9] = 0.0  # dead lanes
    tfar[5::9] = rng.uniform(0.5, 4.0, len(tfar[5::9]))
    rays = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (o, d, np.full(n_rays, 1e-4), tfar)]
    return pack, rays


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["closest", "any", "mixed"])
def test_kernel_matches_twin(cuda, mode):
    pack, (o, d, tn, tf) = _case(cuda)
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
def test_walk_routes_cuda_tensors_to_the_kernel(cuda):
    pack, rays = _case(cuda, n_rays=512)
    k0, t0 = bvh8.walk_cuda.launches, bvh8.walk_twin.launches
    bvh8.walk(pack, *rays)
    assert bvh8.walk_cuda.launches == k0 + 1 and bvh8.walk_twin.launches == t0
