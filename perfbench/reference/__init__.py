"""Plain NumPy reference of one DeKRR-DDRF fit (arXiv 2405.07791,
Algorithm 1): energy DDRF selection from a given pool, the Eq. 17
auxiliaries on ragged nodes, the Eq. 19 rounds and the predictions.

It imports nothing of the program: it works everything out again from
the inputs the benchmark made (data, partition, pools, c)."""
from perfbench.reference.dekrr import fit, pad

__all__ = ["fit", "pad"]
