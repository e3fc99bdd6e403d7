"""Mean ms of a fit's DDRF selection (every node's `select_features`),
from the benchmark's phase clock, synced at both ends."""


def read(rec):
    times = [f["phases"]["ddrf"] for f in rec.fits if "ddrf" in f["phases"]]
    return sum(times) / len(times) * 1e3 if times else None
