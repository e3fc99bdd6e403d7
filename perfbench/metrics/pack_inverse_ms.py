"""Mean host ms a fit in the program's ``pack.inverse`` span: Eq. 17's
Gauss–Jordan inverse, one Python step a pivot (the span ends when its
last work is enqueued)."""
from perfbench.spans import host_ms_per_fit


def read(rec):
    return host_ms_per_fit(rec, "pack.inverse")
