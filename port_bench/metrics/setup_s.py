"""Set-up: from the process's first line to the first timed frame (imports,
builds where the checkout has none, scene write, load, flatten, warm-up)."""


def read(rec):
    return rec.setup_s
