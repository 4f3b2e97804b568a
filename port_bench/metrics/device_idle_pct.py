"""1 - (the union of the device's activity intervals) / (the profiled
frame's wall), in percent."""
from harness import readers


def read(rec):
    return readers.device_idle_pct(rec)
