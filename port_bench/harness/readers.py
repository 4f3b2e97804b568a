"""Arithmetic the metric readers (metrics/*.py) share: the profiled frame's
device summary, the walks' least bytes and the spans' self time. A reader
returns None where its run recorded nothing for it (an untraced run, a
frame without the profiler, a cell without the span)."""
from __future__ import annotations

import json
import os

from . import trace

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def data(name: str):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def profile(rec):
    """(busy ns, {kernel: [count, ns]}, kernels, wall ns) of the profiled
    frame, or None."""
    if rec.prof is None:
        return None
    if not hasattr(rec, "_summary"):
        busy, by_name, kernels, _ = trace.device_summary(rec.prof["events"])
        rec._summary = (busy, by_name, kernels,
                        rec.prof["host_end_ns"] - rec.prof["host_start_ns"])
    return rec._summary


def walk_ns(by_name) -> int:
    """Device ns of the kernels data/walk_kernels.json names (substrings)."""
    names = data("walk_kernels.json")["kernels"]
    return sum(ns for k, (_, ns) in by_name.items() if any(w in k for w in names))


def walk_floor_bytes(closest: int, any_hit: int, calls: int, n_tris: int) -> int:
    """The least bytes the walk calls move: each ray read once (origin,
    direction, t range: 32 B), each result written once (t, prim, u, v: 16 B
    a closest hit; 4 B an any-hit), the scene's triangles read once a call
    (three f32 vertices: 36 B)."""
    return closest * (32 + 16) + any_hit * (32 + 4) + calls * n_tris * 36


def walk_roofline_pct(rec):
    p = profile(rec)
    if p is None or rec.marks is None:
        return None
    (_, _, calls0, (c0, a0)), (_, _, calls1, (c1, a1)) = rec.marks
    ns = walk_ns(p[1])
    if not ns or calls1 == calls0:
        return None
    floor_s = walk_floor_bytes(c1 - c0, a1 - a0, calls1 - calls0, rec.n_tris) / data(
        "peaks.json")["hbm_bytes_per_s"]
    return 100.0 * floor_s / (ns / 1e9)


def walk_device_pct(rec):
    p = profile(rec)
    if p is None or not p[0]:
        return None
    ns = walk_ns(p[1])
    return 100.0 * ns / p[0] if ns else None


def device_idle_pct(rec):
    p = profile(rec)
    if p is None or not p[3]:
        return None
    return 100.0 * (1.0 - p[0] / p[3])


def self_pct(rec, spans):
    """The share of the frames' wall outside the named spans, in percent."""
    if rec.tracer is None:
        return None
    inner = sum(b - a for name in spans for a, b in rec.tracer.spans.get(name, ()))
    frames = sum(b - a for a, b in rec.tracer.spans.get("frame", ()))
    if not inner or not frames:
        return None
    return 100.0 * (frames - inner) / frames


def span_ms(rec, name):
    """The mean wall of a span's calls, ms."""
    if rec.tracer is None or not rec.tracer.spans.get(name):
        return None
    v = rec.tracer.spans[name]
    return sum(b - a for a, b in v) / len(v) / 1e6


def peak_gib(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
