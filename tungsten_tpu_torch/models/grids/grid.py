"""Heterogeneous density grids (torch): the reference's grids/ layer.

Port of tungsten_tpu/models/grids/grid.py: the Grid interface (density /
emission / opticalDepth / inverseOpticalDepth, src/core/grids/Grid.hpp:13-25)
over a dense device-resident grid sampled with vectorized trilinear (or
nearest) gathers.

Integration (VdbGrid's integration_method, grids/VdbGrid.hpp:16-27):
exact_linear / exact_nearest (and residual_ratio, which the JAX package maps
onto them) walk the interpolation cells exactly, 2-point Gauss-Legendre per
dual cell (exact for the trilinear cubic along a line) or the midpoint per
nearest cell. That walk is K6 (ops/grid_walk.py, csrc/grid_walk.cu): the
JAX package's `_dda_cells` lax.while_loop, which in eager PyTorch would cost
hundreds of small launches a round, so on the card it is one kernel launch
per grid and call, and on the CPU its plain twin. "raymarching" keeps the
fixed-step trapezoid march (`grid_march`).

`_world_to_grid` is an explicit sum in a fixed order, ((x w0 + y w1) + z w2)
+ w3 per axis, not a matrix product, so that the walk's twin and its kernel
start from the same oq and dq on every device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...math.transform import mat4_from_json
from ...ops import grid_walk

INF = 3.0e38


@dataclass
class DenseGrid:
    """One dense density (+ optional emission) grid with its world <-> grid
    transform. Grid coordinates: continuous [0, nx] x [0, ny] x [0, nz], cell
    (i, j, k) spans [i, i + 1) etc. (VdbGrid's index-space sampling)."""

    density: torch.Tensor  # (nz, ny, nx) f32
    emission: torch.Tensor  # (nz, ny, nx, 3) f32 ((1, 1, 1, 3) zeros when absent)
    w2g: torch.Tensor  # (3, 4) world -> grid affine
    g2w_scale: torch.Tensor  # () mean world units per voxel
    dims: tuple = (1, 1, 1)  # (nx, ny, nz)
    steps: int = 96
    linear: bool = True
    has_emission: bool = False
    # the exact cell walk (DDA + Gauss-2; VdbGrid ExactLinear) or the
    # fixed-step trapezoid march ("raymarching")
    exact: bool = True

    FIELDS = ("density", "emission", "w2g", "g2w_scale")
    STATICS = ("dims", "steps", "linear", "has_emission", "exact")

    @staticmethod
    def from_arrays(arrays: dict, statics: dict, device) -> "DenseGrid":
        """From numpy arrays under FIELDS and the static fields (the port's
        `grid_spec_arrays`, or the JAX DenseGrid's read by name)."""
        t = {k: torch.as_tensor(np.array(arrays[k], np.float32), device=device).contiguous()
             for k in DenseGrid.FIELDS}
        s = dict(statics)
        s["dims"] = tuple(int(x) for x in s["dims"])
        return DenseGrid(**t, **s)


def _world_to_grid(g: DenseGrid, p):
    w = g.w2g
    return p[..., 0:1] * w[:, 0] + p[..., 1:2] * w[:, 1] + p[..., 2:3] * w[:, 2] + w[:, 3]


def _flat(q):
    return q.reshape(-1, 3)


def _sample_nearest(g: DenseGrid, q):
    return grid_walk.sample_nearest(g.density, _flat(q)).reshape(q.shape[:-1])


def _sample_linear(g: DenseGrid, q, arr=None):
    """Trilinear with zero outside; cell centers at integer + 0.5."""
    a = g.density if arr is None else arr
    out = grid_walk.sample_linear(a, _flat(q))
    return out.reshape(q.shape[:-1] + out.shape[1:])


def grid_density(g: DenseGrid, p):
    q = _world_to_grid(g, p)
    return _sample_linear(g, q) if g.linear else _sample_nearest(g, q)


def grid_emission(g: DenseGrid, p):
    if not g.has_emission:
        return torch.zeros(p.shape[:-1] + (3,), device=p.device)
    return _sample_linear(g, _world_to_grid(g, p), arr=g.emission)


def _grid_span(g: DenseGrid, o, d, t0, t1):
    """Clip [t0, t1] to the ray's overlap with the grid bounds (a slab test
    in grid space)."""
    nx, ny, nz = g.dims
    oq = _world_to_grid(g, o)
    dq = _world_to_grid(g, o + d) - oq
    hi = torch.tensor([nx, ny, nz], dtype=torch.float32, device=o.device)
    safe = torch.where(torch.abs(dq) < 1e-12, 1e-12, dq)
    ta = (0.0 - oq) / safe
    tb = (hi - oq) / safe
    tmin = torch.amax(torch.minimum(ta, tb), dim=-1)
    tmax = torch.amin(torch.maximum(ta, tb), dim=-1)
    return torch.maximum(t0, tmin), torch.minimum(t1, tmax)


def grid_march(g: DenseGrid, o, d, t0, t1):
    """Fixed-step march: (ts (S+1, N), dens (S+1, N), ta, tb); the samples
    are the S+1 segment endpoints over the clipped span, integrated by the
    caller with the trapezoid rule."""
    S = g.steps
    ta, tb = _grid_span(g, o, d, t0, torch.clamp(t1, max=1e30))
    tb = torch.maximum(tb, ta)
    frac = torch.linspace(0.0, 1.0, S + 1, device=o.device)[:, None]
    ts = ta[None, :] + (tb - ta)[None, :] * frac
    p = o[None, :, :] + d[None, :, :] * ts[..., None]
    return ts, grid_density(g, p), ta, tb


def _walk_inputs(g: DenseGrid, o, d, t0, t1):
    """The DDA's per-lane inputs (`_dda_cells`' prologue): oq, dq, and the
    span [ta, tb] clipped to the grid, tb >= ta."""
    ta, tb = _grid_span(g, o, d, t0, torch.clamp(t1, max=1e30))
    tb = torch.maximum(tb, ta)
    oq = _world_to_grid(g, o)
    dq = _world_to_grid(g, o + d) - oq
    return oq.contiguous(), dq.contiguous(), ta.contiguous(), tb.contiguous()


def grid_optical_depth(g: DenseGrid, o, d, t0, t1, mask=None):
    """int_{t0}^{t1} density(o + s d) ds. Exact mode: the cell walk K6
    (Grid::opticalDepth ExactLinear); else the fixed-step trapezoid march.
    mask: the lanes that need the value (None: all); the others return 0."""
    if not g.exact:
        ts, dens, ta, tb = grid_march(g, o, d, t0, t1)
        h = (tb - ta) / g.steps
        tau = h * (torch.sum(dens, dim=0) - 0.5 * (dens[0] + dens[-1]))
        return torch.clamp(tau, min=0.0)
    tau = grid_walk.walk(g.density, g.linear, *_walk_inputs(g, o, d, t0, t1), mode="tau",
                         mask=mask)
    return torch.clamp(tau, min=0.0)


def grid_inverse_optical_depth(g: DenseGrid, o, d, t0, t1, tau_target, mask=None):
    """Smallest t in [t0, t1] with int_{t0}^{t} density = tau_target; INF
    where the total depth falls short (Grid::inverseOpticalDepth)."""
    if g.exact:
        return grid_walk.walk(g.density, g.linear, *_walk_inputs(g, o, d, t0, t1),
                              mode="inverse", tau_target=tau_target.contiguous(), mask=mask)
    ts, dens, ta, tb = grid_march(g, o, d, t0, t1)
    h = ((tb - ta) / g.steps)[None, :]
    seg = 0.5 * (dens[:-1] + dens[1:]) * h  # (S, N) per-segment tau
    cum = torch.cat([torch.zeros_like(seg[:1]), torch.cumsum(seg, dim=0)], dim=0)
    reached = cum[-1] >= tau_target
    # the first segment whose cumulative end reaches the target
    idx = torch.sum((cum < tau_target[None, :]).to(torch.int64), dim=0) - 1
    idx = torch.clamp(idx, 0, g.steps - 1)
    lane = torch.arange(o.shape[0], device=o.device)
    c0 = cum[idx, lane]
    s0 = seg[idx, lane]
    frac = torch.clamp((tau_target - c0) / torch.clamp(s0, min=1e-20), 0.0, 1.0)
    t = ts[idx, lane] + frac * (ts[idx + 1, lane] - ts[idx, lane])
    return torch.where(reached, t, INF)


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def _gaussian_grid(n, sigma=0.25):
    """A procedural unit-cube gaussian blob (tests and demos)."""
    c = (np.arange(n) + 0.5) / n - 0.5
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r2 = x * x + y * y + z * z
    return np.exp(-r2 / (2.0 * sigma * sigma)).astype(np.float32)


def grid_spec_arrays(spec: dict, resolve=None):
    """The host half of `load_grid_spec`: ({FIELDS: numpy}, {STATICS})."""
    gtype = spec.get("type", "vdb")
    emission = None
    if gtype == "gaussian":
        dens = _gaussian_grid(int(spec.get("resolution", 32)), float(spec.get("sigma", 0.25)))
    elif gtype == "dense":
        path = spec["file"]
        if resolve is not None:
            path = resolve(path)
        if path.endswith(".npz"):
            z = np.load(path)
            dens = np.asarray(z["density"], np.float32)
            if "emission" in z.files:
                emission = np.asarray(z["emission"], np.float32)
        else:
            dens = np.asarray(np.load(path), np.float32)
    elif gtype == "vdb":
        from .vdb import read_vdb_grid

        path = spec["file"]
        if resolve is not None:
            path = resolve(path)
        dens, vinfo = read_vdb_grid(path, spec.get("density_name", "density"))
        ename = spec.get("emission_name")
        if ename:
            try:
                emission, _ = read_vdb_grid(path, ename)
            except KeyError:
                emission = None
        # VdbGrid.cpp:241-249 normalize_size=false: world = fileIndex *
        # densitySpacing.min() + densityCenter, the grid spanning file
        # indices minP..maxP, so dense index 0 (file index index_min) sits
        # at translate + index_min * spacing; spec keys still override
        fs = float(np.min(vinfo["voxel_size"]))
        spec = dict(spec)
        spec.setdefault("spacing", fs)
        spec.setdefault("grid_center", (np.asarray(vinfo["translate"])
                                        + fs * np.asarray(vinfo["index_min"], np.float64)).tolist())
    else:
        raise NotImplementedError(f"grid type '{gtype}'")

    dens = dens * float(spec.get("density_scale", 1.0))
    nz, ny, nx = dens.shape[:3]
    if emission is not None:
        escale = float(spec.get("emission_scale", 1.0))
        if emission.ndim == 3:
            emission = emission[..., None].repeat(3, axis=-1)
        emission = emission[..., :3] * escale
        if spec.get("scale_emission_by_density", False):
            emission = emission * dens[..., None]

    # grid index space [0, n]^3 -> world: the grid's box through `transform`,
    # optionally normalized to the unit cube (VdbGrid::load normalize_size)
    xf = mat4_from_json(spec.get("transform", {}))
    if spec.get("normalize_size", True):
        # VdbGrid.cpp:237-240: scale by 1 / max extent, center x and z at the
        # origin, the box's BOTTOM at y = 0
        scale = 1.0 / max(nx, ny, nz)
        off = (-0.5 * nx * scale, 0.0, -0.5 * nz * scale)
        g2o = np.array([[scale, 0, 0, off[0]], [0, scale, 0, off[1]],
                        [0, 0, scale, off[2]], [0, 0, 0, 1.0]], np.float32)
    else:
        # VdbGrid.cpp:241-243: world = p * spacing + the density grid's
        # center (defaults: unit spacing, centered at the origin)
        spacing = float(spec.get("spacing", 1.0))
        center = spec.get("grid_center", [0.0, 0.0, 0.0])
        g2o = np.array([[spacing, 0, 0, float(center[0])], [0, spacing, 0, float(center[1])],
                        [0, 0, spacing, float(center[2])], [0, 0, 0, 1.0]], np.float32)
    g2w = np.asarray(xf, np.float32) @ g2o
    w2g = np.linalg.inv(g2w)[:3, :]
    vox_world = float(np.cbrt(abs(np.linalg.det(g2w[:3, :3])) + 1e-30))
    arrays = dict(
        density=np.ascontiguousarray(dens, np.float32),
        emission=np.ascontiguousarray(
            emission if emission is not None else np.zeros((1, 1, 1, 3)), np.float32),
        w2g=np.asarray(w2g, np.float32), g2w_scale=np.float32(vox_world))
    statics = dict(
        dims=(nx, ny, nz), steps=int(spec.get("steps", 96)),
        linear=spec.get("sampling_method", "exact_linear") != "exact_nearest",
        has_emission=emission is not None,
        exact=spec.get("integration_method", "exact_linear") != "raymarching")
    return arrays, statics


def load_grid_spec(spec: dict, resolve=None, *, device) -> DenseGrid:
    """A DenseGrid on `device` from a scene-JSON grid spec: the reference's
    {"type": "vdb", "file", "transform", ...} block (VoxelMedium.cpp),
    {"type": "dense", "file": x.npy | x.npz (density, and emission)}, or a
    procedural {"type": "gaussian", "resolution", "sigma"}."""
    arrays, statics = grid_spec_arrays(spec, resolve)
    return DenseGrid.from_arrays(arrays, statics, device)
