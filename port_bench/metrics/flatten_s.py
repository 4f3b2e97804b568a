"""The host build: the program's load_scene + flatten_scene in set-up
(scene/load.py, scene/flatten.py, accel/bvh.py, the packs of ops/*)."""


def read(rec):
    return rec.flatten_s
