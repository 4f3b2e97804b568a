"""The bounce loop (integrators/path_tracer.py): _shading_data calls a frame
(one a regen iteration or a lockstep bounce), over the traced window."""


def read(rec):
    if rec.tracer is None or not rec.tracer.counts.get("shading"):
        return None
    return rec.tracer.counts["shading"] / rec.n_frames
