"""`rff_gram`'s share of its roofline over the traced fits: the least
time of its launches (`perfbench.roofline.gram_launches`, live work) over
the device time of the kernels whose names start ``rff_gram``."""
from perfbench import roofline
from perfbench.trace import device_seconds


def read(rec):
    prof = rec.profile
    if not prof:
        return None
    seconds, launches = device_seconds(prof, "rff_gram")
    if not launches or seconds <= 0:
        return None
    traced = [f for f in rec.fits if f["traced"]]
    least = sum(roofline.least_seconds(
        roofline.gram_launches(rec.shape(f["rounds"]))) for f in traced)
    return 100.0 * least / seconds
