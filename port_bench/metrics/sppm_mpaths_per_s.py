"""SPPM's rate: camera paths of the window's frames (the camera lanes of
their gather passes, one pass an iteration) over the wall from the
window's start to its last frame's end, in millions a second."""


def read(rec):
    return rec.paths / rec.window_s / 1e6
