"""Host ms a fit summed over the program's ``ddrf.select`` spans (one a
node): candidate scoring and the top-D pick, as the host enqueues them."""
from perfbench.spans import host_ms_per_fit


def read(rec):
    return host_ms_per_fit(rec, "ddrf.select")
