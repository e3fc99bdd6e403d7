"""The fit's operations (`perfbench.roofline.fit_ops` at each fit's
rounds) over its wall time, as a share of 67 TFLOP/s: the window's fits
outside the profiler."""
from perfbench import roofline


def read(rec):
    fits = [f for f in rec.fits if not f["traced"]]
    wall = sum(f["wall_s"] for f in fits)
    if not fits or wall <= 0:
        return None
    ops = sum(roofline.fit_ops(rec.shape(f["rounds"])) for f in fits)
    return 100.0 * ops / wall / roofline.PEAK_FLOPS
