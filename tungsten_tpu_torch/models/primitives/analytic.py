"""Analytic sphere / disk / cylinder primitives (torch).

Port of tungsten_tpu/models/primitives/analytic.py (lines 38-598): the
table, the closest analytic hit over all A prims as (A, N) tensor math, the
geometric normal at a surface point, and the host-side parameter
extraction. It is plain tensor code, as the JAX module is plain XLA; no
kernel is involved.

Identifier space: analytic prims occupy virtual ids [T, T+A) after the T
real triangles; the flatten appends A rows to the shading table, and the
integrator overrides the normal and uv of those rows at the hit.

`hit_geom` gives the geometric normal and uv at any hit (a triangle or an
analytic prim), `occluded_analytic` the any-hit test the shadow rays run
before the triangle walk. Analytic emitters are sampled from a point
(`sample_direct`, `direct_pdf`) and by position (`sample_position`, the
light tracer's and BDPT's emitter start, through
`lights.sample_emitter_position`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INF = 3.0e38

SPHERE, DISK, CYLINDER = 0, 1, 2

# the table's arrays in order, with their numpy types (build_table)
FIELDS = (("ptype", np.int32), ("pos", np.float32), ("radius", np.float32),
          ("inv_rot", np.float32), ("axis", np.float32), ("half_h", np.float32),
          ("cos_apex", np.float32), ("capped", np.bool_), ("frame_t", np.float32),
          ("frame_b", np.float32), ("area", np.float32))


@dataclass
class AnalyticTable:
    ptype: torch.Tensor  # (A,) int32
    pos: torch.Tensor  # (A, 3) center / base position
    radius: torch.Tensor  # (A,)
    inv_rot: torch.Tensor  # (A, 3, 3) world->local rotation (sphere uv, cyl)
    axis: torch.Tensor  # (A, 3) disk normal / cylinder axis (unit)
    half_h: torch.Tensor  # (A,) cylinder half height
    cos_apex: torch.Tensor  # (A,) disk emission-cone cos (<= -1: none)
    capped: torch.Tensor  # (A,) bool
    frame_t: torch.Tensor  # (A, 3) disk TangentFrame tangent
    frame_b: torch.Tensor  # (A, 3) disk TangentFrame bitangent
    area: torch.Tensor  # (A,)

    @property
    def n(self) -> int:
        return self.ptype.shape[0]

    @staticmethod
    def from_arrays(arrays: dict, device) -> "AnalyticTable":
        """From numpy arrays under FIELDS' names (build_table's, or the JAX
        table's attributes)."""
        return AnalyticTable(**{k: torch.as_tensor(np.asarray(arrays[k], dt), device=device)
                                for k, dt in FIELDS})


@dataclass
class AnaHit:
    t: torch.Tensor  # (N,) INF = miss
    k: torch.Tensor  # (N,) int64 analytic prim index, -1 = miss
    uv: torch.Tensor  # (N, 2) reference uv at the hit
    ng: torch.Tensor  # (N, 3) geometric normal at the hit
    back: torch.Tensor  # (N,) bool hitBackside(data)


def _rows(x):
    return x[:, None]  # (A,) -> (A, 1) broadcasting against (N,)


def _rot(ir, i, x, y, z):
    """Row i of the per-prim (A, 3, 3) rotation applied to (A, N) vectors."""
    return _rows(ir[:, i, 0]) * x + _rows(ir[:, i, 1]) * y + _rows(ir[:, i, 2]) * z


def _rot_t(ir, i, x, y, z):
    """Row i of the transposed rotation (local -> world) on (A, N) vectors."""
    return _rows(ir[:, 0, i]) * x + _rows(ir[:, 1, i]) * y + _rows(ir[:, 2, i]) * z


def intersect_analytic(ana: AnalyticTable, o, d, tnear, tfar) -> AnaHit:
    """Closest analytic hit per lane over all A >= 1 prims, (A, N)
    vectorized, with the reference intersectors' accept rules (t in the open
    interval (tnear, tfar), nearer-candidate ordering per type)."""
    n = o.shape[0]
    a = ana.n
    dev = o.device
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    inf = torch.tensor(float("inf"), device=dev)

    def zeros():
        return torch.zeros((a, n), dtype=torch.float32, device=dev)

    is_sph = _rows(ana.ptype == SPHERE)
    is_dsk = _rows(ana.ptype == DISK)
    is_cyl = _rows(ana.ptype == CYLINDER)
    px_, py_, pz_ = (_rows(ana.pos[:, i]) for i in range(3))
    r_ = _rows(ana.radius)
    ir = ana.inv_rot

    best_t = tfar.expand(a, n)
    t_out = torch.full((a, n), float("inf"), dtype=torch.float32, device=dev)

    # ---- sphere (Sphere.cpp:60-95): |o + t d - c|^2 = r^2 ----------------
    sx, sy, sz = ox - px_, oy - py_, oz - pz_
    b = sx * dx + sy * dy + sz * dz
    c = sx * sx + sy * sy + sz * sz - r_ * r_
    det_sq = b * b - c
    det = torch.sqrt(torch.clamp(det_sq, min=0.0))
    t0 = -b - det
    t1 = -b + det
    ok0 = (det_sq >= 0.0) & (t0 > tnear) & (t0 < best_t)
    ok1 = (det_sq >= 0.0) & (t1 > tnear) & (t1 < best_t) & ~ok0
    t_s = torch.where(ok0, t0, t1)
    hit_s = is_sph & (ok0 | ok1)
    t_out = torch.where(hit_s, t_s, t_out)
    back = hit_s & ok1
    # normal + uv (Sphere::intersectionInfo): Ng = (p - c) / r; uv from
    # localN = invRot * Ng
    hx = (sx + t_s * dx) / r_
    hy = (sy + t_s * dy) / r_
    hz = (sz + t_s * dz) / r_
    lx, ly, lz = (_rot(ir, i, hx, hy, hz) for i in range(3))
    u_sph = torch.atan2(ly, lx) * (0.5 / np.pi) + 0.5
    u_sph = torch.where(torch.isnan(u_sph), 0.0, u_sph)
    v_sph = torch.acos(torch.clamp(lz, -1.0, 1.0)) * (1.0 / np.pi)
    u_out = torch.where(hit_s, u_sph, zeros())
    v_out = torch.where(hit_s, v_sph, zeros())
    ngx = torch.where(hit_s, hx, zeros())
    ngy = torch.where(hit_s, hy, zeros())
    ngz = torch.where(hit_s, hz, zeros())
    best_t = torch.where(hit_s, t_s, best_t)

    # ---- disk (Disk.cpp:64-86) -------------------------------------------
    nx_, ny_, nz_ = (_rows(ana.axis[:, i]) for i in range(3))
    n_dot_w = nx_ * dx + ny_ * dy + nz_ * dz
    t_d = (nx_ * (px_ - ox) + ny_ * (py_ - oy) + nz_ * (pz_ - oz)) / n_dot_w
    qx = ox + t_d * dx - px_
    qy = oy + t_d * dy - py_
    qz = oz + t_d * dz - pz_
    r_sq = qx * qx + qy * qy + qz * qz
    hit_d = is_dsk & (t_d > tnear) & (t_d < best_t) & (r_sq <= r_ * r_)
    t_out = torch.where(hit_d, t_d, t_out)
    # uv (Disk::intersectionInfo): angle u and radial v
    du = qx * _rows(ana.frame_t[:, 0]) + qy * _rows(ana.frame_t[:, 1]) + qz * _rows(ana.frame_t[:, 2])
    dv = qx * _rows(ana.frame_b[:, 0]) + qy * _rows(ana.frame_b[:, 1]) + qz * _rows(ana.frame_b[:, 2])
    u_out = torch.where(hit_d, torch.atan2(du, dv) * (0.5 / np.pi) + 0.5, u_out)
    v_out = torch.where(hit_d, torch.sqrt(r_sq) / r_, v_out)
    ngx = torch.where(hit_d, nx_ + 0.0 * t_d, ngx)
    ngy = torch.where(hit_d, ny_ + 0.0 * t_d, ngy)
    ngz = torch.where(hit_d, nz_ + 0.0 * t_d, ngz)
    back = torch.where(hit_d, -n_dot_w < _rows(ana.cos_apex), back)
    best_t = torch.where(hit_d, t_d, best_t)

    # ---- cylinder (Cylinder.cpp:55-116): local frame via invRot ----------
    rel_x, rel_y, rel_z = ox - px_, oy - py_, oz - pz_
    plx, ply, plz = (_rot(ir, i, rel_x, rel_y, rel_z) for i in range(3))
    dlx, dly, dlz = (_rot(ir, i, dx, dy, dz) for i in range(3))
    inv_r = 1.0 / torch.clamp(r_, min=1e-30)
    hh = _rows(ana.half_h)
    p2x, p2y = plx * inv_r, plz * inv_r  # xz plane, scaled to the unit circle
    d2x, d2y = dlx * inv_r, dlz * inv_r
    cyl_t = torch.full((a, n), float("inf"), dtype=torch.float32, device=dev)
    cyl_ng = (zeros(), zeros(), zeros())
    cyl_uv = (zeros(), zeros())
    cyl_back = torch.zeros((a, n), dtype=torch.bool, device=dev)
    # caps, +1 then -1 (ray.setFarT ordering preserved by sequential wheres)
    capped_ = _rows(ana.capped)
    for sign in (1.0, -1.0):
        t_c = (sign * hh - ply) / dly
        chx = p2x + t_c * d2x
        chy = p2y + t_c * d2y
        ok = (is_cyl & capped_ & (torch.abs(dly) > 1e-6)
              & (t_c > tnear) & (t_c < best_t) & (t_c < cyl_t)
              & (chx * chx + chy * chy < 1.0))
        cyl_t = torch.where(ok, t_c, cyl_t)
        cyl_ng = tuple(torch.where(ok, v, g) for v, g in
                       zip((0.0 * t_c, torch.full_like(t_c, sign), 0.0 * t_c), cyl_ng))
        cyl_uv = (torch.where(ok, chx * 0.5 + 0.5, cyl_uv[0]),
                  torch.where(ok, chy * 0.5 + 0.5, cyl_uv[1]))
        cyl_back = torch.where(ok, sign * dly > 0.0, cyl_back)
    # lateral surface
    a_q = d2x * d2x + d2y * d2y
    b_q = p2x * d2x + p2y * d2y
    c_q = p2x * p2x + p2y * p2y - 1.0
    det_sq_c = b_q * b_q - a_q * c_q
    det_c = torch.sqrt(torch.clamp(det_sq_c, min=0.0))
    for sign in (1.0, -1.0):
        t_l = (-b_q - sign * det_c) / torch.where(a_q == 0.0, 1e-30, a_q)
        h_l = ply + dly * t_l
        ok = (is_cyl & (det_sq_c >= 0.0)
              & (t_l > tnear) & (t_l < best_t) & (t_l < cyl_t)
              & (h_l >= -hh) & (h_l <= hh))
        lhx = p2x + t_l * d2x
        lhy = p2y + t_l * d2y
        cyl_t = torch.where(ok, t_l, cyl_t)
        cyl_ng = tuple(torch.where(ok, v, g) for v, g in zip((lhx, 0.0 * t_l, lhy), cyl_ng))
        # uv: (atan2(n.z, n.x) / 2pi + 0.5, h / (2 hh) + 0.5), intersectionInfo
        u_l = torch.atan2(lhy, lhx) * (0.5 / np.pi) + 0.5
        v_l = h_l / torch.clamp(2.0 * hh, min=1e-30) + 0.5
        cyl_uv = (torch.where(ok, u_l, cyl_uv[0]), torch.where(ok, v_l, cyl_uv[1]))
        cyl_back = torch.where(ok, sign < 0.0, cyl_back)
    hit_c = is_cyl & torch.isfinite(cyl_t)
    t_out = torch.where(hit_c, cyl_t, t_out)
    # the local normal back to world: rot * n_local = invRot^T * n_local
    ngx = torch.where(hit_c, _rot_t(ir, 0, *cyl_ng), ngx)
    ngy = torch.where(hit_c, _rot_t(ir, 1, *cyl_ng), ngy)
    ngz = torch.where(hit_c, _rot_t(ir, 2, *cyl_ng), ngz)
    u_out = torch.where(hit_c, cyl_uv[0], u_out)
    v_out = torch.where(hit_c, cyl_uv[1], v_out)
    back = torch.where(hit_c, cyl_back, back)

    # ---- nearest across prims: the lowest index among the least t --------
    hit_any = torch.isfinite(t_out)
    tm = torch.where(hit_any, t_out, inf)
    tmin = torch.min(tm, dim=0).values
    arange_a = torch.arange(a, device=dev)[:, None]
    ksel = torch.min(torch.where(hit_any & (tm == tmin), arange_a, a), dim=0).values
    one = arange_a == ksel

    def pick(arr):
        return torch.sum(torch.where(one, arr, 0.0), dim=0)

    found = ksel < a
    ng = torch.stack([pick(ngx), pick(ngy), pick(ngz)], dim=-1)
    nl = torch.sqrt(torch.clamp(torch.sum(ng * ng, dim=-1, keepdim=True), min=1e-30))
    return AnaHit(
        t=torch.where(found, tmin, INF),
        k=torch.where(found, ksel, -1),
        uv=torch.stack([pick(u_out), pick(v_out)], dim=-1),
        ng=ng / nl,
        back=torch.any(one & back, dim=0),
    )


def normal_at(ana: AnalyticTable, k, p):
    """Geometric normal of analytic prim k (N,) at surface point p (N, 3).
    Ns = Ng for all three types (intersectionInfo of Sphere.cpp:119,
    Disk.cpp:115, Cylinder.cpp:126). A cylinder point at the half height
    with radial distance < r is on a cap."""
    k = torch.clamp(k, 0, max(ana.n - 1, 0)).long()
    pos = ana.pos[k]
    r = ana.radius[k]
    ptype = ana.ptype[k]
    rel = p - pos

    n_sph = rel / torch.clamp(r, min=1e-30)[..., None]
    n_dsk = ana.axis[k]

    ir = ana.inv_rot[k]  # (N, 3, 3)
    pl = torch.einsum("nij,nj->ni", ir, rel)
    rad2 = pl[..., 0] ** 2 + pl[..., 2] ** 2
    hh = ana.half_h[k]
    on_cap = ana.capped[k] & (
        torch.abs(torch.abs(pl[..., 1]) - hh) * torch.clamp(r, min=1e-30)
        < torch.abs(torch.sqrt(torch.clamp(rad2, min=0.0)) - r) + 1e-7)
    zero = torch.zeros_like(hh)
    n_loc = torch.where(
        on_cap[..., None],
        torch.stack([zero, torch.sign(pl[..., 1]), zero], -1),
        torch.stack([pl[..., 0], zero, pl[..., 2]], -1) / torch.clamp(r, min=1e-30)[..., None])
    n_cyl = torch.einsum("nji,nj->ni", ir, n_loc)  # rot = invRot^T

    n = torch.where((ptype == SPHERE)[..., None], n_sph,
                    torch.where((ptype == DISK)[..., None], n_dsk, n_cyl))
    return n / torch.sqrt(torch.clamp(torch.sum(n * n, -1, keepdim=True), min=1e-30))


def occluded_analytic(ana: AnalyticTable, o, d, tnear, tfar):
    """Any-hit over analytic prims. The reference's Disk::occluded is
    one-sided (front side only, Disk.cpp:88-105); sphere and cylinder
    occlude from both sides."""
    h = intersect_analytic(ana, o, d, tnear, tfar)
    k = torch.clamp(h.k, min=0)
    is_disk_hit = (h.k >= 0) & (ana.ptype[k] == DISK)
    n_dot_w = torch.sum(ana.axis[k] * d, dim=-1)
    return (h.k >= 0) & torch.where(is_disk_hit, n_dot_w < 0.0, True)


def hit_geom(scene, prim, p, u, v):
    """(ng, uv) at a hit on `prim`: a triangle id or an analytic virtual id
    >= T. For analytic prims the Hit's (u, v) carry the intersectionInfo uv
    directly (not barycentrics) and the normal is recomputed from p."""
    tri = torch.clamp(prim, min=0)
    w0 = (1.0 - u - v)[..., None]
    uv = (scene.tri_uv0[tri] * w0 + scene.tri_uv1[tri] * u[..., None]
          + scene.tri_uv2[tri] * v[..., None])
    ng = scene.tri_ng[tri]
    if scene.ana is not None:
        n_tris = scene.tris.v0.shape[0]
        is_a = (prim >= n_tris)[..., None]
        ng = torch.where(is_a, normal_at(scene.ana, prim - n_tris, p), ng)
        uv = torch.where(is_a, torch.stack([u, v], -1), uv)
    return ng, uv


def _frame_to_global(axis, local):
    """TangentFrame(axis).toGlobal(local), batched (Duff et al. branchless)."""
    s = torch.where(axis[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + axis[..., 2])
    b = axis[..., 0] * axis[..., 1] * a
    t = torch.stack([1.0 + s * axis[..., 0] ** 2 * a, s * b, -s * axis[..., 0]], -1)
    bt = torch.stack([b, s + axis[..., 1] ** 2 * a, -axis[..., 1]], -1)
    return t * local[..., 0:1] + bt * local[..., 1:2] + axis * local[..., 2:3]


def sample_direct(ana: AnalyticTable, k, p, u2, u1):
    """Primitive::sampleDirect of analytic prim k (N,) from points p (N, 3):

    sphere   : a uniform direction in the cone the sphere subtends, pdf =
               uniformSphericalCapPdf; invalid inside (Sphere.cpp:173-191);
    disk     : a uniform point on the disk, its front side and emission cone
               only, pdf = r^2 / (cos * pi r^2) (Disk.cpp:177-193);
    cylinder : a uniform surface point (a cap by its area share), pdf =
               r^2 / (cos * area) (Cylinder.cpp:152-201).

    Returns (d, dist, pdf, uv, valid), uv the intersectionInfo uv at the lit
    point (the emission is evaluated there)."""
    k = torch.clamp(k, 0, max(ana.n - 1, 0)).long()
    ptype = ana.ptype[k]
    pos = ana.pos[k]
    r = ana.radius[k]
    area = ana.area[k]
    ir = ana.inv_rot[k]

    # ---- sphere: a cap sample about L = pos - p ----
    lv = pos - p
    dist_c = torch.sqrt(torch.clamp(torch.sum(lv * lv, -1), min=1e-30))
    c = dist_c * dist_c - r * r
    outside = c > 0.0
    cos_max = torch.sqrt(torch.clamp(c, min=0.0)) / dist_c
    cos_t = cos_max + u2[..., 1] * (1.0 - cos_max)  # uniformSphericalCap(xi, cosMax)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = u2[..., 0] * (2.0 * np.pi)
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], -1)
    d_sph = _frame_to_global(lv / dist_c[..., None], local)
    b = dist_c * cos_t
    det = torch.sqrt(torch.clamp(b * b - c, min=0.0))
    t_sph = b - det
    pdf_sph = (0.5 / np.pi) / torch.clamp(1.0 - cos_max, min=1e-9)
    hp = p + d_sph * t_sph[..., None]  # uv at the hit (Sphere::intersectionInfo)
    ng_s = (hp - pos) / torch.clamp(r, min=1e-30)[..., None]
    ln = torch.einsum("nij,nj->ni", ir, ng_s)
    u_s = torch.atan2(ln[..., 1], ln[..., 0]) * (0.5 / np.pi) + 0.5
    u_s = torch.where(torch.isnan(u_s), 0.0, u_s)
    v_s = torch.acos(torch.clamp(ln[..., 2], -1.0, 1.0)) * (1.0 / np.pi)

    # ---- disk: a uniform point ----
    rt = torch.sqrt(torch.clamp(u2[..., 0], min=0.0)) * r
    phi_d = u2[..., 1] * (2.0 * np.pi)
    lqx = rt * torch.cos(phi_d)
    lqy = rt * torch.sin(phi_d)
    nrm = ana.axis[k]
    q_d = pos + lqx[..., None] * ana.frame_b[k] + lqy[..., None] * ana.frame_t[k]
    dv_d = q_d - p
    r_sq_d = torch.sum(dv_d * dv_d, -1)
    t_dsk = torch.sqrt(torch.clamp(r_sq_d, min=1e-30))
    d_dsk = dv_d / t_dsk[..., None]
    cos_d = -torch.sum(nrm * d_dsk, -1)
    front_d = torch.sum(nrm * (p - pos), -1) >= 0.0
    cone_ok = -(-cos_d) >= ana.cos_apex[k]  # -d.n >= cosApex
    pdf_dsk = r_sq_d / torch.clamp(cos_d * area, min=1e-30)
    # uv: intersectionInfo at q (x along the bitangent, y along the tangent)
    u_d = torch.atan2(lqy, lqx) * (0.5 / np.pi) + 0.5
    u_d = torch.where((lqx == 0.0) & (lqy == 0.0), 0.0, u_d)
    v_d = rt / torch.clamp(r, min=1e-30)

    # ---- cylinder: a uniform position, the area pdf ----
    hh = ana.half_h[k]
    cap_area = 2.0 * np.pi * r * r
    p_cap = torch.where(ana.capped[k], cap_area / torch.clamp(area, min=1e-30), 0.0)
    take_cap = u1 < p_cap
    # the cap pick rescales u1; its upper half picks the sign
    u1r = torch.where(take_cap, u1 / torch.clamp(p_cap, min=1e-9), 0.0)
    sign = torch.where(u1r < 0.5, -1.0, 1.0)
    cx = rt * torch.cos(phi_d)  # a uniform disk point, as the disk branch's
    cy = rt * torch.sin(phi_d)
    zero = torch.zeros_like(hh)
    pc_cap = torch.stack([cx, sign * hh, cy], -1)
    n_cap = torch.stack([zero, sign, zero], -1)
    uv_cap = torch.stack([cx / torch.clamp(r, min=1e-30) * 0.5 + 0.5,
                          cy / torch.clamp(r, min=1e-30) * 0.5 + 0.5], -1)
    phi_c = u2[..., 0] * (2.0 * np.pi)  # the lateral surface: uniformCylinder(xi)
    zc = u2[..., 1] * 2.0 - 1.0
    pc_lat = torch.stack([torch.cos(phi_c) * r, zc * hh, torch.sin(phi_c) * r], -1)
    n_lat = torch.stack([torch.cos(phi_c), torch.zeros_like(zc), torch.sin(phi_c)], -1)
    uv_lat = torch.stack([u2[..., 0], u2[..., 1]], -1)
    tc = take_cap[..., None]
    pc = torch.where(tc, pc_cap, pc_lat)
    nc = torch.where(tc, n_cap, n_lat)
    uv_c = torch.where(tc, uv_cap, uv_lat)
    q_c = pos + torch.einsum("nji,nj->ni", ir, pc)  # rot * p + pos
    ng_c = torch.einsum("nji,nj->ni", ir, nc)
    dv_c = q_c - p
    r_sq_c = torch.sum(dv_c * dv_c, -1)
    t_cyl = torch.sqrt(torch.clamp(r_sq_c, min=1e-30))
    d_cyl = dv_c / t_cyl[..., None]
    cos_c = -torch.sum(ng_c * d_cyl, -1)
    pdf_cyl = r_sq_c / torch.clamp(cos_c * area, min=1e-30)

    is_s, is_d = ptype == SPHERE, ptype == DISK

    def sel3(a, b, c):
        return torch.where(is_s[..., None], a, torch.where(is_d[..., None], b, c))

    def sel1(a, b, c):
        return torch.where(is_s, a, torch.where(is_d, b, c))

    uv = sel3(torch.stack([u_s, v_s], -1), torch.stack([u_d, v_d], -1), uv_c)
    valid = sel1(outside, front_d & cone_ok & (cos_d > 0.0), cos_c > 0.0)
    return (sel3(d_sph, d_dsk, d_cyl), sel1(t_sph, t_dsk, t_cyl),
            sel1(pdf_sph, pdf_dsk, pdf_cyl), uv, valid)


def direct_pdf(ana: AnalyticTable, k, p, hit_p, d):
    """Primitive::directPdf of a bsdf-strategy ray from p that hits analytic
    prim k at hit_p along d: the sphere's spherical-cap pdf
    (Sphere.cpp:222-227), r^2 / (|cos| * area) for disk and cylinder
    (Disk.cpp:225-232; sampleDirect's area form for the cylinder)."""
    k = torch.clamp(k, 0, max(ana.n - 1, 0)).long()
    r = ana.radius[k]
    dist_c = torch.sqrt(torch.clamp(torch.sum((ana.pos[k] - p) ** 2, -1), min=1e-30))
    cos_max = torch.sqrt(torch.clamp(dist_c * dist_c - r * r, min=0.0)) / dist_c
    pdf_sph = (0.5 / np.pi) / torch.clamp(1.0 - cos_max, min=1e-9)
    cos_t = torch.abs(torch.sum(normal_at(ana, k, hit_p) * d, -1))
    r_sq = torch.sum((hit_p - p) ** 2, -1)
    pdf_area = r_sq / torch.clamp(cos_t * ana.area[k], min=1e-30)
    return torch.where(ana.ptype[k] == SPHERE, pdf_sph, pdf_area)


def sample_position(ana: AnalyticTable, k, u2, u1):
    """Primitive::samplePosition of analytic prim k (N,), the emitter start
    of the light tracer and BDPT (analytic.py:458-522): a uniform point on
    the sphere (Sphere.cpp:146-160), the disk (Disk.cpp:151-164) or the
    cylinder, a cap by its area share (Cylinder.cpp:152-173). Returns (p,
    ng, uv, pdf = 1 / area); the caller applies the weight pi * area *
    emission."""
    k = torch.clamp(k, 0, max(ana.n - 1, 0)).long()
    ptype = ana.ptype[k]
    pos = ana.pos[k]
    r = ana.radius[k]
    ir = ana.inv_rot[k]
    hh = ana.half_h[k]

    # sphere: a uniform direction; uv = (xi.x + 0.5 wrapped, acos(2 xi.y - 1) / pi)
    zs = u2[..., 1] * 2.0 - 1.0
    rs = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    phi_s = u2[..., 0] * (2.0 * np.pi)
    ln_s = torch.stack([torch.cos(phi_s) * rs, torch.sin(phi_s) * rs, zs], -1)
    ng_s = torch.einsum("nji,nj->ni", ir, ln_s)
    p_s = pos + ng_s * r[..., None]
    u_wrap = torch.where(u2[..., 0] + 0.5 > 1.0, u2[..., 0] - 0.5, u2[..., 0] + 0.5)
    uv_s = torch.stack([u_wrap, torch.acos(torch.clamp(zs, -1.0, 1.0)) * (1.0 / np.pi)], -1)

    # disk: a uniform point; uv = (xi.x + 0.5 wrapped, sqrt(xi.y))
    rt = torch.sqrt(torch.clamp(u2[..., 1], min=0.0)) * r
    phi_d = u2[..., 0] * (2.0 * np.pi)
    q_d = (pos + (rt * torch.cos(phi_d))[..., None] * ana.frame_b[k]
           + (rt * torch.sin(phi_d))[..., None] * ana.frame_t[k])
    uv_d = torch.stack([u_wrap, torch.sqrt(torch.clamp(u2[..., 1], min=0.0))], -1)

    # cylinder: a cap by its area share, else the lateral surface
    cap_area = 2.0 * np.pi * r * r
    p_cap = torch.where(ana.capped[k], cap_area / torch.clamp(ana.area[k], min=1e-30), 0.0)
    take_cap = u1 < p_cap
    u1r = torch.where(take_cap, u1 / torch.clamp(p_cap, min=1e-9), 0.0)
    sign = torch.where(u1r < 0.5, -1.0, 1.0)
    cx = rt * torch.cos(phi_d)  # the disk branch's uniform disk point
    cy = rt * torch.sin(phi_d)
    zero = torch.zeros_like(hh)
    pc_cap = torch.stack([cx, sign * hh, cy], -1)
    n_cap = torch.stack([zero, sign, zero], -1)
    uv_cap = torch.stack([cx / torch.clamp(r, min=1e-30) * 0.5 + 0.5,
                          cy / torch.clamp(r, min=1e-30) * 0.5 + 0.5], -1)
    phi_c = u2[..., 0] * (2.0 * np.pi)
    zc = u2[..., 1] * 2.0 - 1.0
    pc_lat = torch.stack([torch.cos(phi_c) * r, zc * hh, torch.sin(phi_c) * r], -1)
    n_lat = torch.stack([torch.cos(phi_c), torch.zeros_like(zc), torch.sin(phi_c)], -1)
    tc = take_cap[..., None]
    p_c = pos + torch.einsum("nji,nj->ni", ir, torch.where(tc, pc_cap, pc_lat))
    ng_c = torch.einsum("nji,nj->ni", ir, torch.where(tc, n_cap, n_lat))
    uv_c = torch.where(tc, uv_cap, u2)

    is_s, is_d = (ptype == SPHERE)[..., None], (ptype == DISK)[..., None]

    def sel3(a, b, c):
        return torch.where(is_s, a, torch.where(is_d, b, c))

    return (sel3(p_s, q_d, p_c), sel3(ng_s, ana.axis[k], ng_c), sel3(uv_s, uv_d, uv_c),
            1.0 / torch.clamp(ana.area[k], min=1e-30))


# ---------------------------------------------------------------------------
# host-side parameter extraction (flatten time)
# ---------------------------------------------------------------------------

def extract_params(ptype: str, m: np.ndarray, prim: dict) -> dict:
    """prepareForRender parameter extraction from the 4x4 world transform:
    sphere pos = M*0, radius = max scale (Sphere.cpp:285-295); disk center
    M*0, r = max(sx, sz), n = M*(0,1,0), TangentFrame(n), cos(cone_angle)
    (Disk.cpp:315-327); cylinder pos, axis = up, radius = 0.5 max(sx, sz),
    half height 0.5 sy, optional caps (Cylinder.cpp:288-301)."""
    m = np.asarray(m, np.float64)
    pos = m[:3, 3]
    scale = np.linalg.norm(m[:3, :3], axis=0)  # column norms = extractScale
    rot = m[:3, :3] / np.maximum(scale[None, :], 1e-30)
    if ptype == "sphere":
        radius = float(scale.max())
        return dict(
            ptype=SPHERE, pos=pos, radius=radius, inv_rot=rot.T,
            axis=np.array([0.0, 1.0, 0.0]), half_h=0.0, cos_apex=-2.0,
            capped=False, frame_t=np.zeros(3), frame_b=np.zeros(3),
            area=4.0 * np.pi * radius * radius,
        )
    if ptype == "disk":
        r = float(max(scale[0], scale[2]))
        n = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        n = n / max(np.linalg.norm(n), 1e-30)
        cos_apex = float(np.cos(np.deg2rad(float(prim.get("cone_angle", 90.0)))))
        t, b = _tangent_frame(n)
        return dict(
            ptype=DISK, pos=pos, radius=r, inv_rot=rot.T, axis=n,
            half_h=0.0, cos_apex=cos_apex, capped=False,
            frame_t=t, frame_b=b, area=np.pi * r * r,
        )
    if ptype == "cylinder":
        radius = float(0.5 * max(scale[0], scale[2]))
        half_h = float(0.5 * scale[1])
        axis = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        axis = axis / max(np.linalg.norm(axis), 1e-30)
        capped = bool(prim.get("capped", True))
        area = 2.0 * np.pi * radius * 2.0 * half_h
        if capped:
            area += 2.0 * np.pi * radius * radius
        return dict(
            ptype=CYLINDER, pos=pos, radius=radius, inv_rot=rot.T,
            axis=axis, half_h=half_h, cos_apex=-2.0, capped=capped,
            frame_t=np.zeros(3), frame_b=np.zeros(3), area=area,
        )
    raise ValueError(ptype)


def _tangent_frame(n):
    """TangentFrame(n) (Mat/TangentFrame.hpp, Duff et al. branchless)."""
    s = np.copysign(1.0, n[2])
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    t = np.array([1.0 + s * n[0] * n[0] * a, s * b, -s * n[0]])
    bt = np.array([b, s + n[1] * n[1] * a, -n[1]])
    return t, bt


def build_table(entries) -> dict | None:
    """Numpy arrays of the table (FIELDS) from extract_params entries; None
    for no entries."""
    if not entries:
        return None
    return {k: np.stack([np.asarray(e[k]) for e in entries]).astype(dt) for k, dt in FIELDS}
