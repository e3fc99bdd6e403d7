"""Mean ms of a fit's Eq. 19 solve (`solve_batched` to tol), from the
benchmark's phase clock, synced at both ends."""


def read(rec):
    times = [f["phases"]["solve"] for f in rec.fits
             if "solve" in f["phases"]]
    return sum(times) / len(times) * 1e3 if times else None
