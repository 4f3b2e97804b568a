"""The plain reference renderer: a path tracer in plain torch, written from
the published models and independent of the program under test.

It reads the scene files itself (scene.py), builds its own BVH (bvh.py) and
estimates every pixel with next-event estimation (one light chosen
uniformly: the env map, importance-sampled by its texels' luminance times
sin(theta), or the emissive triangles by area) combined with BSDF sampling
by the power heuristic; Russian roulette past the third bounce. Its
estimator differs from the program's (other samples, other strategies), so
the two agree in expectation only: the benchmark compares block means
against their standard errors.

`mode="pt"` estimates the path tracer's integral: paths of up to the
scene's max_bounces vertices. `mode="sppm"` estimates the integral that
progressive photon mapping converges to as its radius shrinks: a camera
chain through smooth (specular) vertices of at most `prefix_max` hits, the
emission those hits see, and at the chain's first non-specular vertex x the
light that reaches x along light paths of at most `after_max` surface hits
(x counted), i.e. the photons of at most `after_max` bounces, and at
most max_bounces hits counted over both sides (the photon map's gather
gate: camera hits to x plus light-path hits below max_bounces + 1).

Every float of the render is in the scene's dtype (scene.load(dtype=...)),
so the same code in bfloat16 is the lower-precision control. The
accumulators are float64.
"""
from __future__ import annotations

import math

import torch

from .bvh import Bvh
from .scene import CONDUCTOR, DIELECTRIC, LAMBERT, RefScene

EPS = 5e-4  # ray offset: Tungsten's scene epsilon
INV_PI = 1.0 / math.pi


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(a):
    return a / torch.clamp(torch.linalg.vector_norm(a.float(), dim=-1, keepdim=True),
                           min=1e-30).to(a.dtype)


def _frame(n):
    """An orthonormal basis (t, b, n) around unit n (Duff et al. 2017)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b, -sign * n[:, 0]], -1)
    bb = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return t, bb, n


def _to_local(f, v):
    return torch.stack([_dot(f[0], v), _dot(f[1], v), _dot(f[2], v)], -1)


def _to_world(f, v):
    return f[0] * v[:, :1] + f[1] * v[:, 1:2] + f[2] * v[:, 2:3]


def _cosine_hemisphere(u):
    r = torch.sqrt(u[:, 0])
    phi = 2.0 * math.pi * u[:, 1]
    z = torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


# -- GGX microfacet reflection off a conductor (Walter et al. 2007) ----------

def _ggx_d(alpha, m):
    c2 = m[:, 2] * m[:, 2]
    a2 = alpha * alpha
    tan2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-20)
    d = a2 * INV_PI / torch.clamp(c2 * c2 * (a2 + tan2) ** 2, min=1e-20)
    return torch.where(m[:, 2] > 0, d, torch.zeros_like(d))


def _ggx_g1(alpha, v, m):
    c2 = v[:, 2] * v[:, 2]
    tan2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-20)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    return torch.where(_dot(v, m) * v[:, 2] > 0, g, torch.zeros_like(g))


def _conductor_fresnel(eta, k, cos_i):
    ci = torch.clamp(cos_i, min=0.0)[:, None]
    c2 = ci * ci
    s2 = torch.clamp(1.0 - c2, min=0.0)
    inner = eta * eta - k * k - s2
    ab = torch.sqrt(torch.clamp(inner * inner + 4.0 * eta * eta * k * k, min=0.0))
    a = torch.sqrt(torch.clamp((ab + inner) * 0.5, min=0.0))
    rs = (ab + c2 - 2.0 * a * ci) / torch.clamp(ab + c2 + 2.0 * a * ci, min=1e-20)
    rp = (c2 * ab + s2 * s2 - 2.0 * a * ci * s2) / torch.clamp(
        c2 * ab + s2 * s2 + 2.0 * a * ci * s2, min=1e-20)
    return 0.5 * (rs + rs * rp)


def _dielectric_fresnel(eta, cos_i):
    """eta = n_incident / n_transmitted, cos_i >= 0. -> (F, cos_t)."""
    s2t = eta * eta * (1.0 - cos_i * cos_i)
    ct = torch.sqrt(torch.clamp(1.0 - s2t, min=0.0))
    rs = (eta * cos_i - ct) / torch.clamp(eta * cos_i + ct, min=1e-20)
    rp = (eta * ct - cos_i) / torch.clamp(eta * ct + cos_i, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    tir = s2t > 1.0
    return torch.where(tir, torch.ones_like(f), f), torch.where(tir, torch.zeros_like(ct), ct)


class _Surface:
    """The material parameters of a batch of hits."""

    def __init__(self, sc: RefScene, mat, uv):
        self.kind = sc.m_type[mat]
        ch = sc.m_checker[mat]
        on = ((torch.floor(uv[:, 0].float() * ch[:, 6].float()).to(torch.int64)
               ^ torch.floor(uv[:, 1].float() * ch[:, 7].float()).to(torch.int64)) & 1) == 1
        checker = torch.where(on[:, None], ch[:, 0:3], ch[:, 3:6])
        self.albedo = torch.where((ch[:, 6] > 0)[:, None], checker, sc.m_albedo[mat])
        self.eta, self.k = sc.m_eta[mat], sc.m_k[mat]
        self.alpha, self.ior = sc.m_alpha[mat], sc.m_ior[mat]
        self.smooth = self.kind == DIELECTRIC

    def eval(self, wi, wo):
        """(f * |cos wo| (N, 3), pdf (N,)) of the non-specular lobes."""
        up = (wi[:, 2] > 0) & (wo[:, 2] > 0)
        f_l = self.albedo * (INV_PI * wo[:, 2])[:, None]
        p_l = INV_PI * wo[:, 2]
        h = _normalize(wi + wo)
        a = self.alpha
        d = _ggx_d(a, h)
        g = _ggx_g1(a, wi, h) * _ggx_g1(a, wo, h)
        f_c = self.albedo * _conductor_fresnel(self.eta, self.k, _dot(wi, h)) * (
            d * g * 0.25 / torch.clamp(wi[:, 2], min=1e-20))[:, None]
        p_c = d * h[:, 2] * 0.25 / torch.clamp(_dot(wi, h).abs(), min=1e-20)
        lam = (self.kind == LAMBERT)[:, None]
        f = torch.where(lam, f_l, f_c)
        p = torch.where(lam[:, 0], p_l, p_c)
        ok = up & ~self.smooth
        return torch.where(ok[:, None], f, torch.zeros_like(f)), torch.where(
            ok, p, torch.zeros_like(p))

    def sample(self, wi, u2, u1):
        """-> (wo, weight f|cos|/pdf (N, 3), pdf, specular, valid)."""
        dt = wi.dtype
        # lambert
        wo_l = _cosine_hemisphere(u2)
        # conductor: a GGX normal, reflected
        a = self.alpha
        tan2 = a * a * u2[:, 0] / torch.clamp(1.0 - u2[:, 0], min=1e-7)
        cos_t = 1.0 / torch.sqrt(1.0 + tan2)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = 2.0 * math.pi * u2[:, 1]
        m = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], -1)
        wim = _dot(wi, m)
        wo_c = 2.0 * wim[:, None] * m - wi
        # dielectric: the Fresnel lottery between reflection and refraction
        outside = wi[:, 2] > 0
        eta = torch.where(outside, 1.0 / self.ior, self.ior)
        fr, ct = _dielectric_fresnel(eta, wi[:, 2].abs())
        refl = u1 < fr
        wo_r = wi * torch.tensor([-1.0, -1.0, 1.0], dtype=dt, device=wi.device)
        wo_t = torch.stack([-eta * wi[:, 0], -eta * wi[:, 1],
                            torch.where(outside, -ct, ct)], -1)
        wo_d = torch.where(refl[:, None], wo_r, wo_t)
        w_d = torch.where(refl, torch.ones_like(eta), eta * eta)

        lam, con = self.kind == LAMBERT, self.kind == CONDUCTOR
        wo = torch.where(lam[:, None], wo_l, torch.where(con[:, None], wo_c, wo_d))
        f, p = self.eval(wi, wo)
        w_nonspec = f / torch.clamp(p, min=1e-30)[:, None]
        weight = torch.where(self.smooth[:, None], (self.albedo * w_d[:, None]), w_nonspec)
        valid = torch.where(self.smooth, fr < 1.0 + refl.to(dt),
                            (wi[:, 2] > 0) & (wo[:, 2] > 0) & (p > 0))
        valid = valid & torch.where(con, wim > 0, torch.ones_like(valid))
        return wo, weight, p, self.smooth, valid


class Reference:
    """The scene's BVH, its lights and the camera, ready to render."""

    def __init__(self, sc: RefScene):
        self.sc = sc
        self.bvh = Bvh(sc.v0, sc.v1, sc.v2)
        dev, dt = sc.v0.device, sc.v0.dtype
        emissive = torch.nonzero((sc.emit > 0).any(-1)).squeeze(1)
        self.em_tri = emissive
        area = 0.5 * torch.linalg.vector_norm(
            torch.cross((sc.v1 - sc.v0)[emissive], (sc.v2 - sc.v0)[emissive], dim=-1).float(),
            dim=-1)
        self.em_area = float(area.sum()) if emissive.numel() else 0.0
        self.em_cdf = torch.cumsum(area, 0) / max(self.em_area, 1e-30)
        self.n_lights = int(sc.env is not None) + int(emissive.numel() > 0)
        if sc.env is not None:
            h, w = sc.env.shape[:2]
            lum = (sc.env.float() * torch.tensor([0.2126, 0.7152, 0.0722], device=dev)).sum(-1)
            v_c = 1.0 - (torch.arange(h, device=dev) + 0.5) / h
            wgt = lum * torch.sin(v_c * math.pi)[:, None]
            self.env_w = wgt / wgt.sum() * (w * h)  # pdf over the unit uv square
            self.env_cdf = torch.cumsum(wgt.reshape(-1), 0) / wgt.sum()
            self.env_inv = sc.env_rot.T.contiguous()
        self.dt = dt

    # -- the env map ---------------------------------------------------------

    def _env_uv(self, d):
        w = d @ self.env_inv.T
        u = torch.atan2(w[:, 2].float(), w[:, 0].float()) / (2.0 * math.pi) + 0.5
        v = torch.acos(torch.clamp(-w[:, 1].float(), -1.0, 1.0)) / math.pi
        return u, v

    def env_radiance(self, d):
        img = self.sc.env
        h, w = img.shape[:2]
        u, v = self._env_uv(d)
        x = u * w - 0.5
        y = (1.0 - v) * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        x1, y1 = (x0 + 1) % w, (y0 + 1) % h
        x0, y0 = x0 % w, y0 % h
        c = (img[y0, x0].float() * (1 - fx) * (1 - fy) + img[y0, x1].float() * fx * (1 - fy)
             + img[y1, x0].float() * (1 - fx) * fy + img[y1, x1].float() * fx * fy)
        return c.to(self.dt)

    def env_pdf(self, d):
        h, w = self.sc.env.shape[:2]
        u, v = self._env_uv(d)
        col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
        row = torch.clamp(((1.0 - v) * h).to(torch.int64), 0, h - 1)
        s = torch.sin(v * math.pi)
        p = self.env_w[row, col] / (2.0 * math.pi * math.pi * torch.clamp(s, min=1e-6))
        return torch.where(s > 1e-6, p, torch.zeros_like(p)).to(self.dt)

    def env_sample(self, u3):
        h, w = self.sc.env.shape[:2]
        i = torch.clamp(torch.searchsorted(self.env_cdf, u3[:, 0].float().contiguous()),
                        max=h * w - 1)
        row, col = i // w, i % w
        u = (col.float() + u3[:, 1].float()) / w
        v = 1.0 - (row.float() + u3[:, 2].float()) / h
        phi, theta = (u - 0.5) * 2.0 * math.pi, v * math.pi
        local = torch.stack([torch.cos(phi) * torch.sin(theta), -torch.cos(theta),
                             torch.sin(phi) * torch.sin(theta)], -1)
        d = (local @ self.sc.env_rot.float().T).to(self.dt)
        return d, self.env_pdf(d)

    # -- the emissive triangles ------------------------------------------------

    def area_sample(self, p, u3):
        sc = self.sc
        k = torch.clamp(torch.searchsorted(self.em_cdf, u3[:, 0].float().contiguous()),
                        max=self.em_tri.numel() - 1)
        tri = self.em_tri[k]
        su = torch.sqrt(u3[:, 1])
        b1, b2 = 1.0 - su, u3[:, 2] * su
        q = sc.v0[tri] * (1 - b1 - b2)[:, None] + sc.v1[tri] * b1[:, None] + sc.v2[tri] * b2[
            :, None]
        to = q - p
        dist = torch.linalg.vector_norm(to.float(), dim=-1).to(self.dt)
        d = to / torch.clamp(dist, min=1e-30)[:, None]
        cos_l = -_dot(d, sc.ng[tri])
        pdf = dist * dist / torch.clamp(cos_l * self.em_area, min=1e-30)
        ok = cos_l > 0
        return d, dist, torch.where(ok, pdf, torch.zeros_like(pdf)), sc.emit[tri], ok

    def area_pdf(self, tri, o, p):
        sc = self.sc
        to = p - o
        dist2 = _dot(to, to)
        d = to / torch.sqrt(torch.clamp(dist2, min=1e-30))[:, None]
        cos_l = -_dot(d, sc.ng[tri])
        return dist2 / torch.clamp(cos_l * self.em_area, min=1e-30)

    # -- the paths ---------------------------------------------------------------

    def trace(self, gen, pix, mode="pt", prefix_max=8, after_max=6):
        """One path a lane, lane j through pixel pix[j] (row-major). The
        lanes still alive are compacted every bounce. -> radiance (n, 3)
        float64, non-finite samples zeroed."""
        sc, dt = self.sc, self.dt
        dev = sc.v0.device
        w, h = sc.res
        n = pix.shape[0]

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=dev).to(dt)

        px, py = (pix % w).to(dt), (pix // w).to(dt)
        uf = rand(n, 2)
        f = torch.where(uf < 0.5, torch.sqrt(2.0 * uf) - 1.0,
                        1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * uf, min=0.0)))
        local = torch.stack([-1.0 + (px + 0.5 + f[:, 0]) * (2.0 / w),
                             (h / w) - (py + 0.5 + f[:, 1]) * (2.0 / w),
                             torch.full_like(px, sc.plane_dist)], -1)
        rad = torch.zeros((n, 3), dtype=torch.float64, device=dev)
        # the live lanes' state
        lane = torch.arange(n, device=dev)
        d = _normalize(local) @ sc.cam_rot.T
        o = sc.cam_pos.expand(n, 3).clone()
        tmin = torch.full((n,), 1e-4, dtype=dt, device=dev)
        thr = torch.ones((n, 3), dtype=dt, device=dev)
        prev_pdf = torch.zeros(n, dtype=dt, device=dev)  # 0: a smooth vertex or the camera
        after = torch.full((n,), -1, dtype=torch.int64, device=dev)  # sppm: hits since x
        lim = torch.zeros(n, dtype=torch.int64, device=dev)  # sppm: the most hits after x
        p_sel = 1.0 / max(self.n_lights, 1)
        sppm = mode == "sppm"
        if sppm and sc.env is not None:
            raise ValueError("reference: the sppm integral is read for closed scenes only")
        prefix_max = min(prefix_max, sc.max_bounces)
        after_max = min(after_max, sc.max_bounces)

        def add(mask, val):
            rad.index_add_(0, lane[mask], val[mask].double())

        for b in range(prefix_max + after_max if sppm else sc.max_bounces):
            m = lane.shape[0]
            if not m:
                break
            inf = torch.full((m,), float("inf"), dtype=dt, device=dev)
            t, tri, bu, bv = self.bvh.query(o, d, tmin, inf)
            did = tri >= 0
            if sppm:
                after = torch.where(did & (after >= 0), after + 1, after)
                counts = (after < 0) | (after <= lim)
            else:
                counts = torch.ones_like(did)
            # escapes
            if sc.env is not None:
                pl = p_sel * self.env_pdf(d)
                wb = prev_pdf * prev_pdf / torch.clamp(prev_pdf * prev_pdf + pl * pl, min=1e-30)
                wgt = torch.where(prev_pdf > 0, wb, torch.ones_like(wb))
                add(~did, thr * self.env_radiance(d) * wgt[:, None])
            tri_c = torch.clamp(tri, min=0)
            p = o + d * t[:, None]
            ng = sc.ng[tri_c]
            wgt3 = torch.stack([1 - bu - bv, bu, bv], -1)
            ns = _normalize(sc.n0[tri_c] * wgt3[:, :1] + sc.n1[tri_c] * wgt3[:, 1:2]
                            + sc.n2[tri_c] * wgt3[:, 2:])
            uv = (sc.uv[tri_c] * wgt3[:, :, None]).sum(1)
            # emission where a path meets an emitter's front
            if self.em_tri.numel():
                pl = p_sel * self.area_pdf(tri_c, o, p)
                wb = prev_pdf * prev_pdf / torch.clamp(prev_pdf * prev_pdf + pl * pl, min=1e-30)
                wgt = torch.where(prev_pdf > 0, wb, torch.ones_like(wb))
                add(did & (_dot(d, ng) < 0) & counts, thr * sc.emit[tri_c] * wgt[:, None])
            srf = _Surface(sc, sc.mat[tri_c], uv)
            if sppm:  # the chain's first non-specular vertex is x, hit b + 1
                at_x = did & (after < 0) & ~srf.smooth
                after = torch.where(at_x, torch.zeros_like(after), after)
                lim = torch.where(at_x, min(sc.max_bounces - (b + 1), after_max), lim)
            flip = (_dot(ns, d) > 0) & ~srf.smooth
            fr = _frame(torch.where(flip[:, None], -ns, ns))
            wi = _to_local(fr, -d)
            # next-event estimation at the non-specular vertices
            nee = did & ~srf.smooth & (b < sc.max_bounces - 1)
            if sppm:
                nee = nee & (after >= 0) & (after + 1 <= lim)
            if self.n_lights and bool(nee.any()):
                u = rand(m, 4)
                use_env = torch.full((m,), sc.env is not None, device=dev)
                if sc.env is not None and self.em_tri.numel():
                    use_env = u[:, 0] < 0.5
                ld, lpdf, lrad = d, torch.zeros_like(t), torch.zeros_like(thr)
                lok, ldist = torch.zeros_like(nee), inf
                if sc.env is not None:
                    ed, epdf = self.env_sample(u[:, 1:4])
                    ld, lpdf, lrad, lok = ed, epdf, self.env_radiance(ed), epdf > 0
                if self.em_tri.numel():
                    ad, adist, apdf, arad, aok = self.area_sample(p, u[:, 1:4])
                    ld = torch.where(use_env[:, None], ld, ad)
                    lpdf = torch.where(use_env, lpdf, apdf)
                    lrad = torch.where(use_env[:, None], lrad, arad)
                    lok = torch.where(use_env, lok, aok)
                    ldist = torch.where(use_env, inf, adist * (1.0 - 1e-3))
                fl, pb = srf.eval(wi, _to_local(fr, ld))
                pl = p_sel * lpdf
                wl = pl * pl / torch.clamp(pl * pl + pb * pb, min=1e-30)
                contrib = fl * lrad * (wl / torch.clamp(pl, min=1e-30))[:, None]
                cand = nee & lok & (contrib.abs().amax(1) > 0)
                _, blk, _, _ = self.bvh.query(p, ld, torch.full_like(t, EPS),
                                              torch.where(cand, ldist, torch.zeros_like(t)),
                                              any_hit=True)
                add(cand & (blk < 0), thr * contrib)
            # the continuation
            wo, weight, pdf, spec, valid = srf.sample(wi, rand(m, 2), rand(m))
            thr = thr * weight
            alive = did & valid & (thr.abs().amax(1) > 0)
            if sppm:
                alive = alive & torch.where(after < 0, torch.full_like(alive, b + 1 < prefix_max),
                                            after + 1 <= lim)
            else:
                alive = alive & (b + 1 < sc.max_bounces)
            if b >= 3:
                q = thr.abs().amax(1)
                rr = q < 0.1
                live = rand(m) < q
                thr = torch.where((rr & live)[:, None], thr / torch.clamp(q, min=1e-30)[:, None],
                                  thr)
                alive = alive & (~rr | live)
            keep = torch.nonzero(alive).squeeze(1)
            lane, o, d = lane[keep], p[keep], _to_world(fr, wo)[keep]
            thr, after, lim = thr[keep], after[keep], lim[keep]
            prev_pdf = torch.where(spec, torch.zeros_like(pdf), pdf)[keep]
            tmin = torch.full((keep.shape[0],), EPS, dtype=dt, device=dev)
        return torch.where(torch.isfinite(rad), rad, torch.zeros_like(rad))

    def render(self, spp, seed, mode="pt", max_lanes=1 << 22, **kw):
        """spp samples a pixel, as many passes in one wavefront as max_lanes
        holds -> (mean (H, W, 3), per-sample variance (H, W, 3)), float64
        on the device."""
        w, h = self.sc.res
        n_pix = w * h
        dev = self.sc.v0.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
        s1 = torch.zeros((n_pix, 3), dtype=torch.float64, device=dev)
        s2 = torch.zeros_like(s1)
        per = max(1, min(spp, max_lanes // n_pix))
        done = 0
        while done < spp:
            k = min(per, spp - done)
            pix = torch.arange(n_pix, device=dev).repeat(k)
            x = self.trace(gen, pix, mode, **kw)
            s1.index_add_(0, pix, x)
            s2.index_add_(0, pix, x * x)
            done += k
        mean = s1 / spp
        var = torch.clamp(s2 / spp - mean * mean, min=0.0) * (spp / max(spp - 1, 1))
        return mean.reshape(h, w, 3), var.reshape(h, w, 3)
