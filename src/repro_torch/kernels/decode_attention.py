"""Single-token decode attention — CUDA kernel and its plain version.

Replaces `src/repro/kernels/decode_attention.py::flash_decode_pallas`
(`_flash_decode_kernel`), which the reference reaches through
`repro.kernels.ops.flash_decode`; in the port the model's decode step runs
it in every attention layer (`repro_torch.models.layers.decode_attention`,
backend ``cuda``):

    out[b, h] = softmax(q[b, h] · k[b, :len, kv]ᵀ · dh^-0.5)
                · v[b, :len, kv]

for q [B, 1, H, dh], k/v caches [B, S, K, dh] (GQA: query head
h = kv·G + g, G = H / K) and per-(batch, kv head) lengths ``lens``
[B·K] int32, positions ≥ len masked with the finite −1e30 and the sum
floored at 1e-30 before the divide.

The kernel (`csrc/flash_decode.cu`) gives one block to each (batch, kv
head) row, reads the cache in place through its batch and position
strides, walks the positions in shared-memory tiles with the online
softmax, and stops at the row's length. The wrapper that checks and
dispatches is `repro_torch.kernels.ops.flash_decode`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_NEG_INF = -1e30


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lens: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: q [B, 1, H, dh], k/v [B, S, K, dh],
    lens [B·K] int → [B, 1, H, dh] in q's dtype, over the whole cache in
    one pass (scores masked at positions ≥ len)."""
    b, _, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) * dh ** -0.5
    pos = torch.arange(s, device=q.device)
    valid = pos < lens.reshape(b, kh, 1, 1).to(pos.dtype)
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v) / torch.clamp_min(l, 1e-30)
    return out.reshape(b, 1, h, dh)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lens: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked CUDA f32 tensors (q and out
    contiguous [B, 1, H, dh]; k/v [B, S, K, dh] with dh and the head axis
    contiguous, 16-byte aligned; lens [B·K] int32), writing out on the
    current stream."""
    b, _, h, dh = q.shape
    kh = k.shape[2]
    lib = _build.library("flash_decode")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_decode_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        b, kh, h // kh, dh, float(dh ** -0.5), stream)
    _build.check(code, f"flash_decode launch ({h // kh} query heads per "
                 f"kv head at head_dim {dh}; one block's shared memory "
                 f"must fit the 227 KiB a block may take)")
