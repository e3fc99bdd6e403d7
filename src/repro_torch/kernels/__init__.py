"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (sources in ``csrc/``).

* rff_gram.py      — fused random-feature Gram blocks of Eq. 17
                     (``csrc/rff_gram.cu``)
* dekrr_step.py    — one Eq. 19 round over all nodes, with the optional
                     activation mask of asynchronous gossip
                     (``csrc/dekrr_step.cu``)
* dekrr_solve.py   — R Eq. 19 rounds in one persistent launch of one
                     thread-block cluster per node (``csrc/dekrr_solve.cu``,
                     sized by ``chain_plan``), the R-round asynchronous
                     gossip chain on the same clusters
                     (``csrc/dekrr_async_solve.cu``) and the R-round
                     Chebyshev chain, one block per node
                     (``csrc/dekrr_cheb_solve.cu``); shared node bodies in
                     ``csrc/dekrr_common.cuh``
* rff_features.py  — the serving tier's feature map Z = scale·cos(ΩX + b)
                     in f64/f32 and the bf16 arrangement of
                     ``rff_features_lowp`` (``csrc/rff_features.cu``)
* decode_attention.py — single-token GQA decode attention of the LLM
                     serving path, reading the KV cache in place, each
                     row's positions split across blocks in chunks of
                     ``decode_plan`` (``csrc/flash_decode.cu``)
* ref.py           — plain featurize / Gram / decode-attention versions
* ops.py           — the public wrappers (layout, checks, device dispatch,
                     launch counts)
* _build.py        — nvcc build of ``csrc/*.cu`` and ctypes loading

Nothing is compiled at import; the first CUDA launch builds its kernel.
"""
from repro_torch.kernels import ops
from repro_torch.kernels.ops import (dekrr_async_solve, dekrr_cheb_solve,
                                     dekrr_solve, dekrr_step, flash_decode,
                                     rff_features, rff_features_lowp,
                                     rff_gram, rff_gram_batched)

__all__ = ["dekrr_async_solve", "dekrr_cheb_solve", "dekrr_solve",
           "dekrr_step", "flash_decode", "ops", "rff_features",
           "rff_features_lowp", "rff_gram", "rff_gram_batched"]
