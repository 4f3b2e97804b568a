"""The driver's self time (renderer/render.py, renderer/framebuffer.py): the
share of the frames' wall outside the integrator calls (trace_regen_batch
and trace_batch as renderer/render.py binds them; trace_photons,
build_photon_grid and gather_pass of integrators/photon_map.py), each span
synchronised with the device at its edges. `driver_self_pct.pt` and
`driver_self_pct.sppm` both read it: a cell opens only its integrator's spans."""
from harness import readers


def read(rec):
    return readers.self_pct(rec, ("pt.regen", "pt.lockstep", "sppm.photons", "sppm.grid",
                                  "sppm.gather"))
