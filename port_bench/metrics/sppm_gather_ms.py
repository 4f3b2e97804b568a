"""The photon map: the wall of a gather_pass call (the camera chain, K7 and
the physics on its pairs), synchronised at its edges, mean over the traced
window."""
from harness import readers


def read(rec):
    return readers.span_ms(rec, "sppm.gather")
