"""Path tracing's rate: camera paths of the window's frames (the samples
their framebuffers counted) over the wall from the window's start to its
last frame's end, in millions a second."""


def read(rec):
    return rec.paths / rec.window_s / 1e6
