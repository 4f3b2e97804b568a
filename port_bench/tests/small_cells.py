"""Small sizes of the benchmark's cells for the CPU tests: the cells' own
files with the scene cut to the port's `small` sizes (a 2,000-triangle
ball, 64x48, 6 bounces, 2^12 photons) and 4-spp frames, and the cells'
own limits.

But SPPM's `noise`: with 64 times fewer photons an iteration the frame's
noise, held against the reference's (which takes no photons), reads about
three times the full size's: sound small frames read 17.4-26.2 (13 seeds),
the half_photons fault 31.3-48.2 (10 seeds), on the CPU. The small cell's
limit sits between them."""
import copy

from harness import spec

SMALL = {"sphere_segments": [50, 20], "sky": [128, 64], "resolution": [64, 48], "spp": 4,
         "max_bounces": 6, "photon_count": 1 << 12}
SMALL_SPPM_NOISE = 29.0


def small_cell(name: str, spp: int = 4) -> spec.Cell:
    cell = copy.deepcopy(spec.load_cell(name))
    sc = cell.config
    sc.update({k: v for k, v in SMALL.items() if k in sc})
    cell.traffic["frame_spp"] = spp
    if cell.traffic["integrator"] == "progressive_photon_map":
        cell.cell["limits"]["noise"] = SMALL_SPPM_NOISE
    return cell
