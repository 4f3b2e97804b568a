"""The photon map: the wall of a build_photon_grid call (the key sort and
the cell ranges), synchronised at its edges, mean over the traced window."""
from harness import readers


def read(rec):
    return readers.span_ms(rec, "sppm.grid")
