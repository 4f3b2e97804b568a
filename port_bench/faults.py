"""Faults planted under the timed path, to show that `correct` comes out false
on each: tests/test_port_bench_check.py plants them on the CPU, control.py
--fault on the card at a cell's own size. `plant(kind, integrator, set_)`
replaces one or two entries of the program through `set_(module, name,
value)` (pytest's monkeypatch.setattr, or setattr for a whole process).

- unchanged: the per-pixel sums left as they were (zero);
- half_pixels: half the pixels left out, the mean of the rest in their place;
- half_samples (path tracing): each regen batch traces half its passes and
  doubles its sums, so the frame keeps its expectation and the framebuffer
  counts every sample;
- half_photons (SPPM): each iteration traces half its photons and the
  gather divides by the half it traced;
- altered: one 32 x 32 block's answers doubled where they are produced.
"""
from __future__ import annotations

import torch

KINDS = {"path_tracer": ("unchanged", "half_pixels", "half_samples", "altered"),
         "progressive_photon_map": ("unchanged", "half_pixels", "half_photons", "altered")}


def _per_pixel(kind, rad, w):
    """rad (N, 3), N pixels of rows of w, broken as `kind` says."""
    n = rad.shape[0]
    if kind == "unchanged":
        return torch.zeros_like(rad)
    rad = rad.clone()
    if kind == "half_pixels":
        rad[n // 2:] = rad[: n // 2].mean(0)
        return rad
    img = rad.reshape(-1, w, 3)
    img[:32, :32] *= 2.0
    return img.reshape(n, 3)


def plant(kind: str, integrator: str, set_=setattr):
    if kind not in KINDS[integrator]:
        raise ValueError(f"fault {kind!r}: one of {KINDS[integrator]}")
    if integrator == "path_tracer":
        from tungsten_tpu_torch.renderer import render
        orig = render.trace_regen_batch

        def broken(scene, *a, n_passes=1, **kw):
            if kind == "half_samples":
                half = max(1, n_passes // 2)
                return orig(scene, *a, n_passes=half, **kw) * (n_passes / half)
            return _per_pixel(kind, orig(scene, *a, n_passes=n_passes, **kw),
                              scene.meta.res_x)
        set_(render, "trace_regen_batch", broken)
        return
    from tungsten_tpu_torch.integrators import photon_map
    if kind == "half_photons":
        trace, gather = photon_map.trace_photons, photon_map.gather_pass

        def half_traced(scene, seed, lane_ids, *a, **kw):
            return trace(scene, seed, lane_ids[: lane_ids.shape[0] // 2], *a, **kw)

        def half_gathered(scene, seed, lane_ids, px, py, pack, starts, counts, radius,
                          n_emitted, *a, **kw):
            return gather(scene, seed, lane_ids, px, py, pack, starts, counts, radius,
                          n_emitted // 2, *a, **kw)
        set_(photon_map, "trace_photons", half_traced)
        set_(photon_map, "gather_pass", half_gathered)
        return
    orig = photon_map.gather_pass

    def broken(scene, *a, **kw):
        return _per_pixel(kind, orig(scene, *a, **kw), scene.meta.res_x)
    set_(photon_map, "gather_pass", broken)
