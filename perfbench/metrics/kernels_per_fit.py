"""Device kernels a fit launches, all of them (the program's, cuBLAS's
and torch's), from the profiler's timeline of the traced fits."""
from perfbench.trace import is_kernel


def read(rec):
    prof = rec.profile
    if not prof or not prof["fit_ids"] or not prof["device"]:
        return None
    kernels = sum(1 for n, _ in prof["device"] if is_kernel(n))
    return kernels / len(prof["fit_ids"])
