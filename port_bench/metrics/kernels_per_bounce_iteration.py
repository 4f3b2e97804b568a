"""The bounce loop (integrators/path_tracer.py): the CUDA kernels (memcpy and
memset left out) of the profiled frame, every kernel of the frame (walks,
shading, the regen refill, the framebuffer's transfers), over its
_shading_data calls, one a regen iteration or a lockstep bounce."""
from harness import readers


def read(rec):
    p = readers.profile(rec)
    if p is None or rec.marks is None:
        return None
    calls = rec.marks[1][1].get("shading", 0) - rec.marks[0][1].get("shading", 0)
    return p[2] / calls if calls else None
