"""The Eq. 19 chain's share of its roofline over the traced fits: the
least time of its launches (`perfbench.roofline.solve_launches` at each
fit's rounds) over the device time of the kernels whose names start
``dekrr_solve``."""
from perfbench import roofline
from perfbench.trace import device_seconds


def read(rec):
    prof = rec.profile
    if not prof:
        return None
    seconds, launches = device_seconds(prof, "dekrr_solve")
    if not launches or seconds <= 0:
        return None
    traced = [f for f in rec.fits if f["traced"]]
    least = sum(roofline.least_seconds(
        roofline.solve_launches(rec.shape(f["rounds"]))) for f in traced)
    return 100.0 * least / seconds
