"""Share of the traced fits' interval in which no operation ran on the
device, from the profiler's timeline."""


def read(rec):
    prof = rec.profile
    if not prof or prof["window_s"] <= 0 or not prof["device"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
