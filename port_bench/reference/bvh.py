"""The reference's own acceleration structure and ray queries, plain torch.

A linear 8-wide BVH: triangles sorted by the Morton code of their
centroids, LEAF of them a leaf, the leaves padded to a power of 8, and a
complete 8-ary tree over them in heap order (node i has children
8i+1 .. 8i+8). A ray pops one node a round: at an inner node it tests the
eight child boxes and pushes those it enters, farthest first; at a leaf it
tests the leaf's triangles. Entries farther than the ray's best hit are
dropped when popped. The rounds run over the live rays only, compacted
every round. Every float is in the scene's dtype, so the same code serves
the lower-precision control.
"""
from __future__ import annotations

import torch

LEAF = 16
WIDE = 8
STACK = 64


def _morton(c: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of points in [0, 1)^3."""
    q = torch.clamp((c * 1024.0).to(torch.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Bvh:
    def __init__(self, v0, v1, v2):
        dev, dt = v0.device, v0.dtype
        lo = torch.minimum(torch.minimum(v0, v1), v2).float()
        hi = torch.maximum(torch.maximum(v0, v1), v2).float()
        cen = 0.5 * (lo + hi)
        smin, smax = cen.amin(0), cen.amax(0)
        order = torch.argsort(_morton((cen - smin) / torch.clamp(smax - smin, min=1e-12)))
        n = v0.shape[0]
        n_leaves = (n + LEAF - 1) // LEAF
        depth = 0
        while WIDE ** depth < n_leaves:
            depth += 1
        p = WIDE ** depth
        self.first_leaf = (p - 1) // (WIDE - 1)  # the nodes above the leaves
        slots = torch.full((p * LEAF,), -1, dtype=torch.int64, device=dev)
        slots[:n] = order
        self.tri = slots  # leaf j holds slots [j*LEAF, (j+1)*LEAF)
        ok = (slots >= 0)[:, None]
        s = torch.clamp(slots, min=0)
        inf = torch.tensor(float("inf"), device=dev)
        nlo = [torch.where(ok, lo[s], inf).view(p, LEAF, 3).amin(1)]
        nhi = [torch.where(ok, hi[s], -inf).view(p, LEAF, 3).amax(1)]
        while nlo[-1].shape[0] > 1:  # a level's parents: groups of WIDE nodes
            nlo.append(nlo[-1].view(-1, WIDE, 3).amin(1))
            nhi.append(nhi[-1].view(-1, WIDE, 3).amax(1))
        self.lo = torch.cat(nlo[::-1]).to(dt)  # heap order: the root level first
        self.hi = torch.cat(nhi[::-1]).to(dt)
        self.nonempty = (self.lo <= self.hi).all(1)  # the padding's boxes hold nothing
        zero = torch.zeros(3, dtype=dt, device=dev)
        self.v0 = torch.where(ok, v0[s], zero)
        self.e1 = torch.where(ok, v1[s] - v0[s], zero)
        self.e2 = torch.where(ok, v2[s] - v0[s], zero)

    def _boxes(self, nodes, o, inv, tmin, tmax):
        """Slab test of rays (R, 3) against boxes `nodes` (R, K). -> (entry
        t (R, K), entered (R, K))."""
        t0 = (self.lo[nodes] - o[:, None]) * inv[:, None]
        t1 = (self.hi[nodes] - o[:, None]) * inv[:, None]
        tn = torch.maximum(torch.minimum(t0, t1).amax(2), tmin[:, None])
        tf = torch.maximum(t0, t1).amin(2)
        return tn, (tn <= tf) & (tn <= tmax[:, None]) & self.nonempty[nodes]

    def query(self, o, d, tmin, tmax, any_hit=False):
        """Closest hit (or, with any_hit, whether any) of rays o + t d with
        tmin < t < tmax. -> (t, triangle id or -1, u, v)."""
        n, dev, dt = o.shape[0], o.device, o.dtype
        t_best = tmax.clone()
        tri_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        u_best = torch.zeros(n, dtype=dt, device=dev)
        v_best = torch.zeros(n, dtype=dt, device=dev)
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
        live = torch.nonzero(tmax > tmin).squeeze(1)
        m = live.shape[0]
        stack = torch.zeros((m, STACK), dtype=torch.int64, device=dev)  # the root first
        stack_t = torch.zeros((m, STACK), dtype=dt, device=dev)
        sp = torch.ones(m, dtype=torch.int64, device=dev)
        lanes = torch.arange(WIDE, device=dev)
        while live.numel():
            rows = torch.arange(live.shape[0], device=dev)
            sp = sp - 1
            node, t_in = stack[rows, sp], stack_t[rows, sp]
            ro, rd, ri, tmn = o[live], d[live], inv[live], tmin[live]
            tb = t_best[live]
            go = t_in <= tb
            leaf = go & (node >= self.first_leaf)
            done = torch.zeros_like(go)
            lm = torch.nonzero(leaf).squeeze(1)
            if lm.numel():
                slot = ((node[lm] - self.first_leaf) * LEAF)[:, None] + torch.arange(
                    LEAF, device=dev)
                t, u, v = _moller_trumbore(ro[lm, None], rd[lm, None], self.v0[slot],
                                           self.e1[slot], self.e2[slot])
                ok = (t > tmn[lm, None]) & (t < tb[lm, None])
                t = torch.where(ok, t, torch.full_like(t, float("inf")))
                k = torch.argmin(t, 1)[:, None]
                tk = t.gather(1, k)[:, 0]
                found = torch.isfinite(tk)
                g = live[lm][found]
                t_best[g] = tk[found]
                tri_best[g] = self.tri[slot.gather(1, k)[:, 0]][found]
                u_best[g] = u.gather(1, k)[:, 0][found]
                v_best[g] = v.gather(1, k)[:, 0][found]
                if any_hit:
                    done[lm[found]] = True
            im = torch.nonzero(go & ~leaf).squeeze(1)
            if im.numel():
                kids = (WIDE * node[im] + 1)[:, None] + lanes
                tn, hit = self._boxes(kids, ro[im], ri[im], tmn[im], tb[im])
                key = torch.where(hit, tn, torch.full_like(tn, -float("inf")))
                key, order = torch.sort(key, dim=1, descending=True)  # farthest first
                kids = kids.gather(1, order)
                n_hit = hit.sum(1)
                pos = torch.clamp(sp[im, None] + lanes, max=STACK - 1)
                put = lanes < n_hit[:, None]
                st, stt = stack[im], stack_t[im]
                st.scatter_(1, pos, torch.where(put, kids, st.gather(1, pos)))
                stt.scatter_(1, pos, torch.where(put, key, stt.gather(1, pos)))
                stack[im], stack_t[im] = st, stt
                sp[im] = sp[im] + n_hit
            keep = (sp > 0) & ~done
            live, stack, stack_t, sp = live[keep], stack[keep], stack_t[keep], sp[keep]
        return t_best, tri_best, u_best, v_best


def _moller_trumbore(o, d, v0, e1, e2):
    """(t, u, v) of rays against triangles (broadcast); t = inf on a miss."""
    pv = torch.cross(d.expand_as(e2), e2, dim=-1)
    det = (e1 * pv).sum(-1)
    ok = det.abs() > 0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    u = (tv * pv).sum(-1) * inv
    qv = torch.cross(tv, e1, dim=-1)
    v = (d.expand_as(qv) * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1)
    return torch.where(hit, t, torch.full_like(t, float("inf"))), u, v
