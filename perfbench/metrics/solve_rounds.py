"""Mean Eq. 19 rounds run per fit, as `solve_batched` returns them."""


def read(rec):
    rounds = [f["rounds"] for f in rec.fits]
    return sum(rounds) / len(rounds) if rounds else None
