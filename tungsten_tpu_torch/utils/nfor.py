"""NFOR denoiser, the complete pipeline (Bitterli et al. 2016).

Port of tungsten_tpu/utils/nfor.py (:37-235; src/denoiser/denoiser.cpp:
38-133 nforDenoiser, NlMeans.hpp:46-157, Regression.cpp:14-140) in float64
torch, on the inputs' device: the loops over the (2R+1)^2 window shifts
accumulate the weighted normal equations as whole-image maps, and one
batched (H, W, d, d) solve (torch.linalg.solve) fits every pixel's window.
The H100 runs float64 at full rate, so the card does the same arithmetic
as the host. No kernel: nothing here reaches pl.pallas_call in the JAX
package.

Stages (the paper's sections, as denoiser.cpp names them):
  5.1 feature cross-prefiltering: NL-means of buffer A guided by B and the
      other way round (F=3, R=5, k=0.5, varianceScale=2);
  5.2 the main regression for k in {0.5, 1.0}: a collaborative first-order
      fit of half buffer A on B's prefiltered features, NL-means weights;
  5.3 the MSE estimates and the per-channel selection map between the two
      k, both NL-means filtered (F=1, R=9, k=1);
  5.4 the second pass: the combined features filtered again (F=3, R=2) and
      the final regression of the selected result on them.

Inputs are (H, W, C) arrays or tensors: the work runs on the first
input's device (the CPU for an array), and the other inputs follow it.
The normal matrices get a ridge of 1e-4 * trace / d + 1e-12 (the features
are centred, so flat regions make the system near singular), and a solve
that still fails is retried with 1e-6 more on the diagonal, as the JAX
package does.
"""
from __future__ import annotations

import torch

_EPS = 1e-7
_MIN_CENTER_WEIGHT = 1e-4
_DIST_CLAMP = 10000.0


def _f64(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.float64)
    return torch.as_tensor(a, dtype=torch.float64, device=device)


def _box_mean(img, r):
    """Edge-normalized box mean over (2r+1)^2 windows: the mean over the
    in-bounds taps (BoxFilter.hpp:11-37)."""
    h, w = img.shape[:2]
    ii = img.new_zeros((h + 1, w + 1) + tuple(img.shape[2:]))
    ii[1:, 1:] = torch.cumsum(torch.cumsum(img, 0), 1)
    dev = img.device
    y0 = torch.clamp(torch.arange(h, device=dev) - r, 0, h)
    y1 = torch.clamp(torch.arange(h, device=dev) + r + 1, 0, h)
    x0 = torch.clamp(torch.arange(w, device=dev) - r, 0, w)
    x1 = torch.clamp(torch.arange(w, device=dev) + r + 1, 0, w)

    def at(ys, xs):
        return ii.index_select(0, ys).index_select(1, xs)

    s = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)
    cnt = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).to(torch.float64)
    return s / cnt.reshape((h, w) + (1,) * (img.dim() - 2))


def _shifted(img, dx, dy):
    """img translated by (+dx, +dy) lookups, out[y, x] = img[y + dy, x + dx]
    where in bounds, else 0; and the validity mask."""
    h, w = img.shape[:2]
    out = torch.zeros_like(img)
    msk = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    ys0, ys1 = max(0, -dy), min(h, h - dy)
    xs0, xs1 = max(0, -dx), min(w, w - dx)
    if ys0 >= ys1 or xs0 >= xs1:
        return out, msk
    out[ys0:ys1, xs0:xs1] = img[ys0 + dy:ys1 + dy, xs0 + dx:xs1 + dx]
    msk[ys0:ys1, xs0:xs1] = True
    return out, msk


def _nl_dist(guide, variance, dx, dy, k, variance_scale, F):
    """The patchwise NL-means distance to the (dx, dy) neighbour and its
    validity mask (NlMeans.hpp:70-83: Rousselle's modified distance, box
    filtered over the (2F+1)^2 patch, over the taps whose shift is valid)."""
    gq, mq = _shifted(guide, dx, dy)
    vq, _ = _shifted(variance, dx, dy)
    vp = variance * variance_scale
    vq = vq * variance_scale
    sq = (guide - gq) ** 2 - (vp + torch.minimum(vp, vq))
    dist = sq / ((vp + vq) * (k * k) + _EPS)
    dist = torch.clamp(dist, max=_DIST_CLAMP)
    dist = torch.where(mq[..., None], dist, 0.0)
    return _box_mean(dist, F), mq


def _nl_weight(guide, variance, dx, dy, k, variance_scale, F, scalar=False):
    dist, mq = _nl_dist(guide, variance, dx, dy, k, variance_scale, F)
    wgt = torch.exp(-torch.clamp(dist, min=0.0))
    if scalar:
        wgt = wgt.amin(dim=-1)  # convertWeight(float, Vec3f) = in.min()
    else:
        mq = mq[..., None]
    if dx == 0 and dy == 0:
        wgt = torch.clamp(wgt, min=_MIN_CENTER_WEIGHT)
    return torch.where(mq, wgt, 0.0)


def nl_means(image, guide, variance, F, R, k, variance_scale=1.0):
    """The NL-means filter (NlMeans.hpp:96-157): weights from guide and
    variance, values from image, all (H, W, C), per-channel weights."""
    image = _f64(image)
    guide = _f64(guide, image.device)
    variance = _f64(variance, image.device)
    acc = torch.zeros_like(image)
    wacc = torch.zeros_like(image)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            wgt = _nl_weight(guide, variance, dx, dy, k, variance_scale, F)
            iq, _ = _shifted(image, dx, dy)
            acc += wgt * iq
            wacc += wgt
    return acc / torch.clamp(wacc, min=1e-30)


def _design(f, fq, dx, dy):
    """The regression's rows x_q = [1, dx, dy, f_q - f_p], (H, W, d)."""
    h, w = f.shape[:2]
    const = f.new_tensor([1.0, float(dx), float(dy)]).expand(h, w, 3)
    return torch.cat([const, fq - f], dim=-1)


def collaborative_regression(image, guide, features, variance, F, R, k):
    """First-order collaborative regression (Regression.cpp:14-140).

    image / guide / variance (H, W, 3), features (H, W, NF) prefiltered. Per
    pixel p, y_q ~ beta . x_q over the (2R+1)^2 window, x_q = [1, dx, dy,
    f_q - f_p], with NL-means weights w_pq from the guide (varianceScale 2,
    the channels' minimum); every window's prediction for its pixels is
    averaged with the same weights."""
    image = _f64(image)
    dev = image.device
    guide = _f64(guide, dev)
    variance = _f64(variance, dev)
    f = _f64(features, dev)
    h, w = image.shape[:2]
    d = f.shape[-1] + 3

    shifts = [(dx, dy) for dy in range(-R, R + 1) for dx in range(-R, R + 1)]
    # pass 1: the normal equations A(p) = sum_q w x x^T, B(p) = sum_q w x y^T
    A = torch.zeros((h, w, d, d), dtype=torch.float64, device=dev)
    B = torch.zeros((h, w, d, 3), dtype=torch.float64, device=dev)
    wgts = []
    for dx, dy in shifts:
        wgt = _nl_weight(guide, variance, dx, dy, k, 2.0, F, scalar=True)
        wgts.append(wgt)
        fq, _ = _shifted(f, dx, dy)
        yq, _ = _shifted(image, dx, dy)
        x = _design(f, fq, dx, dy)
        wx = wgt[..., None] * x
        A += wx[..., :, None] * x[..., None, :]
        B += wx[..., :, None] * yq[..., None, :]

    # the ridge: the centred features leave A rank-deficient on flat regions
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(d, dtype=torch.float64, device=dev)
    A += (1e-4 * tr[..., None, None] / d + 1e-12) * eye
    try:
        beta = torch.linalg.solve(A, B)  # (H, W, d, 3)
    except torch.linalg.LinAlgError:
        beta = torch.linalg.solve(A + 1e-6 * eye, B)

    # pass 2: window p's prediction for pixel q = p + delta is
    # beta(p) . x_delta(p); gathered at q from p = q - delta, that is the
    # window-centred maps shifted by -delta
    acc = torch.zeros((h, w, 3), dtype=torch.float64, device=dev)
    wacc = torch.zeros((h, w, 1), dtype=torch.float64, device=dev)
    for (dx, dy), wgt in zip(shifts, wgts):
        fq, _ = _shifted(f, dx, dy)
        pred = torch.einsum("hwd,hwdc->hwc", _design(f, fq, dx, dy), beta)
        contrib, _ = _shifted(wgt[..., None] * pred, -dx, -dy)
        wq, _ = _shifted(wgt[..., None], -dx, -dy)
        acc += contrib
        wacc += wq
    return acc / torch.clamp(wacc, min=1e-30)


def nfor(color_a, color_b, color_var, features):
    """Full NFOR (denoiser.cpp:38-133); returns (H, W, 3) float64.

    color_a / color_b: the two half buffers (H, W, 3); color_var: the sample
    variance of the MEAN (H, W, 3); features: dicts of buffer_a, buffer_b
    and variance, each (H, W, C) (C = 3 for albedo and normal, 1 for depth);
    the channels are filtered independently, as the reference's
    slicePixmap does."""
    color_a = _f64(color_a)
    dev = color_a.device
    color_b = _f64(color_b, dev)
    color_var = _f64(color_var, dev)
    image = 0.5 * (color_a + color_b)
    h, w = image.shape[:2]

    def none():
        return torch.zeros((h, w, 0), dtype=torch.float64, device=dev)

    # 5.1 feature cross-prefiltering (denoiser.cpp:42-53): A guided by B
    filt_a, filt_b = [], []
    for ft in features:
        fa = _f64(ft["buffer_a"], dev).reshape(h, w, -1)
        fb = _f64(ft["buffer_b"], dev).reshape(h, w, -1)
        fv = _f64(ft["variance"], dev).reshape(h, w, -1)
        filt_a.append(nl_means(fa, fb, fv, 3, 5, 0.5, variance_scale=2.0))
        filt_b.append(nl_means(fb, fa, fv, 3, 5, 0.5, variance_scale=2.0))
    feats_a = torch.cat(filt_a, dim=-1) if filt_a else none()
    feats_b = torch.cat(filt_b, dim=-1) if filt_b else none()

    # 5.2 the main regression for k in {0.5, 1.0}, 5.3 the MSE estimates
    cand_a, cand_b, mses = [], [], []
    for k in (0.5, 1.0):
        fca = collaborative_regression(color_a, color_b, feats_b, color_var, 3, 9, k)
        fcb = collaborative_regression(color_b, color_a, feats_a, color_var, 3, 9, k)
        mse_a = (color_b - fca) ** 2 - 2.0 * color_var
        mse_b = (color_a - fcb) ** 2 - 2.0 * color_var
        resid = (fcb - fca) ** 2 * 0.25
        noisy_mse = 0.5 * (mse_a + mse_b) - resid
        cand_a.append(fca)
        cand_b.append(fcb)
        mses.append(nl_means(noisy_mse, image, color_var, 1, 9, 1.0, 1.0))

    # 5.3 the selection map (0: k = 0.5, 1: k = 1.0), per channel, filtered
    noisy_sel = (mses[0] >= mses[1]).to(torch.float64)
    sel = nl_means(noisy_sel, image, color_var, 1, 9, 1.0, 1.0)
    result_a = cand_a[0] * (1.0 - sel) + cand_a[1] * sel
    result_b = cand_b[0] * (1.0 - sel) + cand_b[1] * sel

    # 5.4 the second filter pass (denoiser.cpp:107-132)
    final_feats = []
    for fa_, fb_ in zip(filt_a, filt_b):
        comb = 0.5 * (fa_ + fb_)
        final_feats.append(nl_means(comb, comb, (fb_ - fa_) ** 2 * 0.25, 3, 2, 0.5))
    ff = torch.cat(final_feats, dim=-1) if final_feats else none()
    comb_res = 0.5 * (result_a + result_b)
    comb_var = (result_b - result_a) ** 2 * 0.25
    return collaborative_regression(comb_res, comb_res, ff, comb_var, 3, 9, 1.0)
