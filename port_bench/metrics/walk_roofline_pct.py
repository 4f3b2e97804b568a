"""The walks' share of their floor: the least bytes the profiled frame's
walk calls move (readers.walk_floor_bytes) over the HBM rate
(data/peaks.json), against the device time of the walk kernels
(data/walk_kernels.json), in percent."""
from harness import readers


def read(rec):
    return readers.walk_roofline_pct(rec)
