"""Stateless counter-based sample generator.

Port of tungsten_tpu/sampling/sampler.py. Every random number is a pure
function of (seed, lane id, dimension): PCG4D hashes in the plain mode,
Owen-scrambled Sobol' points in the stratified (`strat`) mode. The bits match
the JAX package's exactly.

torch's uint32 supports few operations, so the 32-bit arithmetic runs in
int64 tensors holding values in [0, 2^32): every product is split so it
never leaves int64 (`_mul32`), every result is masked back to 32 bits, and
right shifts act on the masked (non-negative) value, which makes them
logical.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / (1 << 24)

SOBOL_DIMS = 1024
# per-pixel Sobol index bits kept exact (sampler.py SOBOL_LOW_BITS)
SOBOL_LOW_BITS = 8

# the Sobol' direction numbers: the port's own byte copy of the JAX
# package's table (tests/test_torch_data.py holds the two equal)
_SOBOL_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "sobol_matrices.npz")


def _mul32(a, b):
    """(a * b) mod 2^32 for a, b in [0, 2^32) (int64 tensors or ints),
    without int64 overflow: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def pcg4d(v0, v1, v2, v3):
    """PCG4D hash: 4 uint32 (as int64) in -> 4 decorrelated uint32 out."""
    m, a = 1664525, 1013904223
    v0 = (_mul32(v0, m) + a) & MASK32
    v1 = (_mul32(v1, m) + a) & MASK32
    v2 = (_mul32(v2, m) + a) & MASK32
    v3 = (_mul32(v3, m) + a) & MASK32
    v0 = (v0 + _mul32(v1, v3)) & MASK32
    v1 = (v1 + _mul32(v2, v0)) & MASK32
    v2 = (v2 + _mul32(v0, v1)) & MASK32
    v3 = (v3 + _mul32(v1, v2)) & MASK32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + _mul32(v1, v3)) & MASK32
    v1 = (v1 + _mul32(v2, v0)) & MASK32
    v2 = (v2 + _mul32(v0, v1)) & MASK32
    v3 = (v3 + _mul32(v1, v2)) & MASK32
    return v0, v1, v2, v3


def _to_unit_float(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def _reverse_bits32(v):
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & MASK32


def _lk_hash(x, seed):
    """Laine-Karras permutation [Burley 2020]."""
    x = (x + seed) & MASK32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble_u32(v, key):
    """Owen-scramble a radical-inverse value (bits MSB-first)."""
    return _reverse_bits32(_lk_hash(_reverse_bits32(v), key))


@functools.lru_cache(maxsize=None)
def sobol_matrices() -> np.ndarray:
    """(1024, 32) uint32 Grünschloss direction numbers."""
    return np.load(_SOBOL_NPZ)["matrices"]


@functools.lru_cache(maxsize=None)
def sobol_pair_table() -> np.ndarray:
    """(512, 2S) uint32: row j = the first S direction numbers of Sobol'
    dims (2j, 2j+1), stored bit-reversed (sampler.py sobol_pair_table)."""
    M = sobol_matrices()
    S = SOBOL_LOW_BITS
    v = np.concatenate([M[0::2, :S], M[1::2, :S]], axis=1).astype(np.uint32)
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def sobol_window_table(K: int) -> np.ndarray:
    """(512, 2S*K) uint32: pair rows j..j+K-1 side by side (edge-padded)."""
    P = sobol_pair_table()
    idx = np.minimum(np.arange(512)[:, None] + np.arange(K)[None, :], 511)
    return P[idx].reshape(512, -1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _device_table(name: str, K: int, device: torch.device) -> torch.Tensor:
    t = sobol_pair_table() if name == "pair" else sobol_window_table(K)
    return torch.from_numpy(t.astype(np.int64)).to(device)


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    """Python int or tensor -> int64 tensor on like's device, masked."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.full_like(like, int(x) & MASK32, dtype=torch.int64)


class Sampler:
    """Per-lane counter-based sample stream (sampler.py Sampler).

    seed:     (s0, s1) python ints (uint32 each).
    lane_id:  (N,) int64 lane ids (uint32 values).
    dim:      python int or (N,) int64: next dimension to consume.
    table:    optional (N, D, 2) float32 primary-sample table: draws read
              table[:, dim] while dim < D and hash beyond it (the MLT chain
              state: mutations edit the table, replay is exact); dim is
              then a python int.
    samp_idx / pix_key: (N,) int64 per-pixel sample number and pixel id
              (stratified Sobol' mode only).
    pending:  second float of the last pair draw, awaiting next_1d().
    win / stat_off: direction-number window prefetched by prefetch() and
              the count of dimensions consumed since (a python int).
    """

    def __init__(self, seed, lane_id, dim, samp_idx=None, pix_key=None,
                 strat=False, pending=None, win=None, stat_off=0, table=None):
        self.seed = seed
        self.lane_id = lane_id
        self.dim = dim
        self.table = table
        self.samp_idx = samp_idx
        self.pix_key = pix_key
        self.strat = bool(strat) and samp_idx is not None
        self.pending = pending
        self.win = win
        self.stat_off = stat_off

    @staticmethod
    def create(seed, lane_ids, table=None, samp_idx=None, pix_key=None,
               strat=False) -> "Sampler":
        """A sampler at dim 0; stratification is off whenever a table is
        given (sampler.py:204-212)."""
        if isinstance(seed, int):
            seed = (seed & MASK32, (seed >> 32) & MASK32)
        return Sampler((int(seed[0]) & MASK32, int(seed[1]) & MASK32),
                       lane_ids.to(torch.int64) & MASK32, 0, samp_idx, pix_key,
                       strat and table is None, table=table)

    def _replace(self, **kw) -> "Sampler":
        args = dict(seed=self.seed, lane_id=self.lane_id, dim=self.dim,
                    samp_idx=self.samp_idx, pix_key=self.pix_key,
                    strat=self.strat, pending=self.pending, win=self.win,
                    stat_off=self.stat_off, table=self.table)
        args.update(kw)
        return Sampler(**args)

    def _draw(self):
        if not self.strat:
            d = _u32(self.dim, self.lane_id)
            r0, r1, _, _ = pcg4d(self.lane_id, d, _u32(self.seed[0], self.lane_id),
                                 _u32(self.seed[1], self.lane_id))
            u0, u1 = _to_unit_float(r0), _to_unit_float(r1)
        else:
            S = SOBOL_LOW_BITS
            db = _u32(self.dim, self.pix_key)
            use_qmc = 2 * db + 1 < SOBOL_DIMS
            h0, k1, k2, h1 = pcg4d(
                self.pix_key, db, torch.where(use_qmc, 0, self.samp_idx),
                _u32(self.seed[0] ^ 0x50B07, self.pix_key),
            )
            o = self.stat_off
            if self.win is not None and 0 <= o < self.win.shape[-1] // (2 * S):
                rows = self.win[..., 2 * S * o: 2 * S * (o + 1)]
            else:
                table = _device_table("pair", 0, self.pix_key.device)
                rows = table[torch.clamp(db, 0, SOBOL_DIMS // 2 - 1)]
            x = torch.zeros_like(self.pix_key)
            y = torch.zeros_like(self.pix_key)
            for i in range(S):
                on = ((self.samp_idx >> i) & 1) == 1
                x = x ^ torch.where(on, rows[..., i], 0)
                y = y ^ torch.where(on, rows[..., S + i], 0)
            hi = _mul32(self.samp_idx >> S, 0x9E3779B9)
            u0 = torch.where(use_qmc, _to_unit_float(_reverse_bits32(_lk_hash(x, k1 ^ hi))),
                             _to_unit_float(h0))
            u1 = torch.where(use_qmc, _to_unit_float(_reverse_bits32(_lk_hash(y, k2 ^ hi))),
                             _to_unit_float(h1))
        if self.table is not None and self.dim < self.table.shape[1]:
            # the table overrides both the window and the pair gather
            # (sampler.py:280-286); dims past its end keep the draw above
            u0, u1 = self.table[:, self.dim, 0], self.table[:, self.dim, 1]
        return u0, u1

    def next_1d(self) -> Tuple[torch.Tensor, "Sampler"]:
        if self.pending is not None:
            return self.pending, self._advance(0, pending=None)
        u0, u1 = self._draw()
        return u0, self._advance(1, pending=u1)

    def next_2d(self) -> Tuple[torch.Tensor, "Sampler"]:
        u0, u1 = self._draw()
        return torch.stack([u0, u1], dim=-1), self._advance(1, pending=self.pending)

    def skip(self, n: int) -> "Sampler":
        """Advance the dimension counter, dropping any pending half-draw."""
        return self._advance(n, pending=None)

    def prefetch(self, K: int = 8) -> "Sampler":
        """One gather of direction-number pair rows dim..dim+K-1; later draws
        at offsets < K read the window. No-op outside strat mode."""
        if not self.strat:
            return self
        base = torch.clamp(_u32(self.dim, self.pix_key), 0, 511)
        win = _device_table("win", K, self.pix_key.device)[base]
        return self._replace(win=win, stat_off=0)

    def _advance(self, n: int, pending: Optional[torch.Tensor] = None) -> "Sampler":
        win = self.win
        return self._replace(dim=self.dim + n, pending=pending, win=win,
                             stat_off=self.stat_off + n if win is not None else 0)


def sobol02(index: torch.Tensor):
    """Kollig-Keller (0,2)-sequence points for (N,) int64 sample indices:
    (van der Corput radical inverse, Sobol' second dimension) as uint32."""
    d1 = _reverse_bits32(index & MASK32)
    res = torch.zeros_like(index)
    n = index & MASK32
    vdir = 1 << 31
    for _ in range(32):
        res = torch.where((n & 1) == 1, res ^ vdir, res)
        n = n >> 1
        vdir ^= vdir >> 1
    return d1, res


def stratified_cam_2d(lane_id: torch.Tensor, pass_index) -> torch.Tensor:
    """Stratified AA sample: (0,2)-sequence over passes + a per-lane
    Cranley-Patterson rotation. pass_index: python int or (N,) tensor."""
    lane_id = lane_id.to(torch.int64) & MASK32
    d1, d2 = sobol02(_u32(pass_index, lane_id))
    r0, r1, _, _ = pcg4d(lane_id, _u32(0xC0FFEE, lane_id),
                         _u32(0x5EED5EED, lane_id), _u32(0x12345678, lane_id))
    u0 = _to_unit_float(d1) + _to_unit_float(r0)
    u1 = _to_unit_float(d2) + _to_unit_float(r1)
    u0 = u0 - torch.floor(u0)
    u1 = u1 - torch.floor(u1)
    return torch.stack([u0, u1], dim=-1)
