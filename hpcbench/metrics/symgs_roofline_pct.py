"""symgs_roofline_pct (%): the smoother's least time a V-cycle
(roofline_mg.py, from every level's grid) times the V-cycles of the traced
window (the program's ``libhpc.mg.vcycle`` spans), over the device time of
the operations launched inside its ``libhpc.mg.smooth`` spans (one a
symmetric Gauss–Seidel step)."""

from hpcbench import program_spans, roofline_mg

VCYCLE = "libhpc.mg.vcycle"
SMOOTH = "libhpc.mg.smooth"


def read(rec):
    t = rec.trace
    grids = getattr(rec.inputs, "sizes", {}).get("grids")
    if t is None or not grids:
        return None
    least = roofline_mg.smoother_least_seconds(grids, rec.device_kind)
    n = len(program_spans.spans(t, VCYCLE))
    ops = program_spans.ops_launched_in(t, SMOOTH)
    if least is None or n == 0 or not ops:
        return None
    return 100.0 * least * n / t.busy_s(ops)
