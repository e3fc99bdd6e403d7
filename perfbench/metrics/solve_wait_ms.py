"""Host ms a fit summed over the program's ``solve.tol_read`` spans: the
host blocked on the Eq. 19 chain at each tol check."""
from perfbench.spans import host_ms_per_fit


def read(rec):
    return host_ms_per_fit(rec, "solve.tol_read")
