"""The walk kernels' device time over all of the device's busy time in the
profiled frame, in percent."""
from harness import readers


def read(rec):
    return readers.walk_device_pct(rec)
