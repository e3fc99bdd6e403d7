"""Mean host ms a fit in the program's ``pack.stage`` span: the padded
[J, …] inputs of Eq. 17 staged and gathered per neighbour slot, before
the Gram launches."""
from perfbench.spans import host_ms_per_fit


def read(rec):
    return host_ms_per_fit(rec, "pack.stage")
