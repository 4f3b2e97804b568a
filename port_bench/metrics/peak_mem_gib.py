"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start."""
from harness import readers


def read(rec):
    return readers.peak_gib(rec)
