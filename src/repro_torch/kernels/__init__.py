"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

* rff_gram.py     — fused random-feature Gram blocks of Eq. 17
* dekrr_step.py   — one Eq. 19 round over all nodes
* dekrr_solve.py  — R Eq. 19 rounds in one cooperative launch
* ref.py          — plain featurize / Gram versions
* ops.py          — the public wrappers (layout, checks, device dispatch,
                    launch counts)
* _build.py       — nvcc build of ``csrc/*.cu`` and ctypes loading

Nothing is compiled at import; the first CUDA launch builds its kernel.
"""
from repro_torch.kernels import ops
from repro_torch.kernels.ops import (dekrr_solve, dekrr_step, rff_gram,
                                     rff_gram_batched)

__all__ = ["dekrr_solve", "dekrr_step", "ops", "rff_gram",
           "rff_gram_batched"]
