"""Single-token decode attention — CUDA kernel, its launch plan and its
plain versions.

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
floored at 1e-30 before the divide. The operands are f32 or bf16 (one
type for all, the output's too); the arithmetic is f32 in both, as the
reference's kernel keeps m, l and acc in f32 for bf16 operands.

The kernel (`csrc/flash_decode.cu`) splits each (batch, kv head) row's
positions into chunks of `decode_plan`'s length, a function of dh and the
operands' type alone, and runs one block per (row, head block, chunk):
each block streams its chunk through a ring in shared memory (f32: a
cp.async ring; bf16: a producer warp's bulk copies completed on
mbarriers), and the last of a row's active chunks merges their partials
(`flash_decode_split_reference` is its plain version, in the bf16
kernel's order). The wrapper that checks and dispatches is
`repro_torch.kernels.ops.flash_decode`.
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F

from repro_torch.analysis.smem import (SMEM_LIMITS, SMEM_PER_SM,
                                       SMEM_RESERVED_PER_BLOCK,
                                       SmemBudgetError)
from repro_torch.kernels import _build

_NEG_INF = -1e30

DECODE_THREADS = 256
DECODE_LANES = 8                  # lanes per position
DECODE_LANE_GROUPS = DECODE_THREADS // DECODE_LANES   # 32
DECODE_CHUNK_BYTES = 256 << 10    # K and V bytes a block streams
DECODE_MAX_CHUNK_TILES = 64
DECODE_PAIR_STAGE_BYTES = 32 << 10   # two positions a lane group up to it
DECODE_HEAD_BLOCKS = (1, 2, 4)    # query heads a block takes
# shared memory a block may take, an SM's, and the 1 KB of it per block
# that the system keeps (`repro_torch.analysis.smem`)
DECODE_SMEM_LIMIT = SMEM_LIMITS["flash_decode"]
DECODE_SMEM_PER_SM = SMEM_PER_SM
DECODE_SMEM_RESERVED = SMEM_RESERVED_PER_BLOCK
DECODE_THREADS_PER_SM = 2_048
# The bf16 route (`flash_decode_bf16_kernel`): eight consumer warps of 32
# lane groups and one producer warp; a lane holds ⌈dh / 64⌉ 16-byte
# columns and takes 4 / that many positions of a stage (a stage of 128
# positions at dh 64: 32 KB of K and V); a ring of 2 stages and a chunk of
# 16 stages (512 KB of K and V at dh 64 and 128: 2,048 and 1,024
# positions); persistent blocks walk the (chunk, row) units; a merge area
# of at least 34 KB (131 partials at dh 64).
DECODE_BF16_THREADS = 288
DECODE_BF16_LANE_GROUPS = 32
DECODE_BF16_STAGES = 2
DECODE_BF16_CHUNK_TILES = 16
DECODE_BF16_MERGE_BYTES = 34_816
DECODE_BF16_WARPS = 8             # consumer warps
DECODE_MBARRIER_BYTES = 16        # full and empty barrier of a stage
DECODE_FLAG_BYTES = 16            # the last-block flag
DECODE_ALIGN_BYTES = 128          # slack to start the ring on 128 bytes


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Launch plan of `flash_decode` for ``rows`` (batch, kv head) rows of
    ``groups`` query heads at head size ``dh``. Every field is a function
    of (rows, groups, dh) alone: the cache length S and the row lengths
    only pick how many chunks a launch has and which of them run."""

    rows: int
    groups: int
    dh: int
    itemsize: int       # bytes of an operand value: 4 (f32) or 2 (bf16)
    chunk: int          # positions per block, a multiple of `tile`
    ppg: int            # positions a lane group takes from a tile: f32
    #                     1 or 2; bf16 4 / ⌈dh / 64⌉
    tile: int           # positions per ring stage, 32·ppg
    stages: int         # ring stages in shared memory: 3 or 4 (f32), 2 (bf16)
    head_block: int     # query heads per block (1, 2 or 4)
    head_blocks: int    # ⌈groups / head_block⌉
    threads: int
    smem_bytes: int
    blocks_per_sm: int  # by shared memory and threads (registers not known)

    def chunks(self, s: int) -> int:
        """Chunks of a launch over a cache of ``s`` positions."""
        return -(-s // self.chunk)

    def active_chunks(self, length: int) -> range:
        """The chunks that run for a row of ``length`` valid positions;
        the others exit at once."""
        return range(-(-length // self.chunk))

    def grid(self, s: int) -> tuple[int, int]:
        return self.rows * self.head_blocks, self.chunks(s)

    def blocks(self, s: int) -> int:
        x, y = self.grid(s)
        return x * y

    @property
    def counters(self) -> int:
        """uint32 tickets, one per (row, head block)."""
        return self.rows * self.head_blocks

    def record(self, row: int, chunk: int, head: int, s: int) -> int:
        """Offset in floats of the partial (m, l, acc[dh]) of ``head`` of
        ``row`` from ``chunk``, in a launch over ``s`` positions."""
        return ((row * self.chunks(s) + chunk) * self.groups + head) \
            * (2 + self.dh)

    def workspace(self, s: int) -> int:
        """Floats of the partials' workspace of a launch over ``s``
        positions: [rows, chunks, groups, 2 + dh]."""
        return self.rows * self.chunks(s) * self.groups * (2 + self.dh)

    def waves(self, s: int, sms: int = 132) -> float:
        """Blocks of a launch over ``s`` positions in full waves of the
        card (``sms`` SMs, `blocks_per_sm` each)."""
        return self.blocks(s) / (sms * self.blocks_per_sm)

    @property
    def merge_window(self) -> int:
        """bf16: chunks whose partials the row's last block stages and
        folds at a time (windows of its merge area, 2 + dh floats a
        partial of each of its first head block's heads); 0 in f32, which
        folds them from global memory."""
        if self.itemsize != 2:
            return 0
        heads = min(self.groups, self.head_block)
        return max(1, decode_merge_bytes(self.head_block, self.dh) // 4
                   // (heads * (2 + self.dh)))

    def resident(self, sms: int = 132) -> int:
        """bf16: the persistent grid's blocks on a card of ``sms`` SMs
        (the kernel asks the card: its registers may hold fewer), each
        walking the units (chunk, row · head block) that `blocks` counts
        in strides of this many."""
        return sms * self.blocks_per_sm

    def merge_order(self, length: int) -> list[int]:
        """The chunks whose partials a row of ``length`` valid positions
        merges, in the order the bf16 kernel and
        `flash_decode_split_reference` fold them: every active chunk in
        chunk order, each weighted by e^{m_c − M}, M the largest m_c of
        them. (The f32 kernel folds the same partials in a strided
        order.)"""
        return list(self.active_chunks(length))


def decode_columns(dh: int) -> int:
    """16-byte columns (8 bf16 values) a lane of the bf16 route holds:
    1 up to dh 64, 2 up to 128, else 4."""
    return 1 if dh <= 64 else 2 if dh <= 128 else 4


def decode_tiling(groups: int, dh: int, itemsize: int = 4
                  ) -> tuple[int, int, int, int, int]:
    """(ppg, tile, stages, tiles a chunk, head_block) of `decode_plan`
    for ``groups`` query heads at head size ``dh`` and operands of
    ``itemsize`` bytes (any dh ≥ 1: the budget check reads it for shapes
    the card would refuse too)."""
    dh = max(1, dh)
    head_block = next((hb for hb in DECODE_HEAD_BLOCKS if hb >= groups),
                      DECODE_HEAD_BLOCKS[-1])
    if itemsize == 2:
        ppg = 4 // decode_columns(dh)
        return (ppg, ppg * DECODE_BF16_LANE_GROUPS, DECODE_BF16_STAGES,
                DECODE_BF16_CHUNK_TILES, head_block)
    ppg = 2 if 2 * 2 * DECODE_LANE_GROUPS * dh * itemsize \
        <= DECODE_PAIR_STAGE_BYTES else 1
    tile = ppg * DECODE_LANE_GROUPS
    stage_bytes = 2 * tile * dh * itemsize
    stages = 4 if stage_bytes <= 16 << 10 else 3
    tiles = max(1, min(DECODE_MAX_CHUNK_TILES,
                       DECODE_CHUNK_BYTES // stage_bytes))
    return ppg, tile, stages, tiles, head_block


def decode_merge_bytes(head_block: int, dh: int) -> int:
    """bf16: the merge area (`bf16_merge_bytes`): the 8 consumer warps'
    states [warps][head_block][2 + dh] f32, and at least
    DECODE_BF16_MERGE_BYTES for the last block's windows of partials."""
    return max(DECODE_BF16_MERGE_BYTES,
               DECODE_BF16_WARPS * head_block * (2 + dh) * 4)


def decode_smem_bytes(ppg: int, stages: int, head_block: int,
                      dh: int, itemsize: int = 4) -> int:
    """Shared memory of a block in the layout of csrc/flash_decode.cu.
    f32 (`smem_bytes`): the ring [stages][K, V][32·ppg][dh] and the
    block's query rows [head_block][dh], in f32. bf16
    (`bf16_smem_bytes`): the ring [stages][K, V][32·ppg][dh] and a slot a
    stage for a unit's query rows [head_block][dh] in bf16, the query rows
    widened to f32, the merge area (`decode_merge_bytes`), a full and an
    empty mbarrier a stage, the last-block flag and 128 bytes of slack,
    so the ring starts on a 128-byte boundary for the tensor copies."""
    if itemsize == 2:
        return (stages * 2 * ppg * DECODE_BF16_LANE_GROUPS * dh * 2
                + stages * head_block * dh * 2 + head_block * dh * 4
                + decode_merge_bytes(head_block, dh)
                + stages * DECODE_MBARRIER_BYTES + DECODE_FLAG_BYTES
                + DECODE_ALIGN_BYTES)
    return (stages * 2 * ppg * DECODE_LANE_GROUPS * dh + head_block * dh) \
        * itemsize


def decode_vector(itemsize: int) -> int:
    """Values one 16-byte copy moves: 4 in f32, 8 in bf16. dh, and the
    caches' batch and position strides, are multiples of it."""
    return 16 // itemsize


@functools.lru_cache(maxsize=None)
def decode_plan(rows: int, groups: int, dh: int,
                itemsize: int = 4) -> DecodePlan:
    """Launch plan of `flash_decode`. f32: 256 threads a block, eight
    lanes a position, so 32 lane groups; each takes two positions of a
    ring stage while such a stage (64 positions of K and V) is at most
    32 KB (dh ≤ 64), else one; 4 stages while a stage is at most 16 KB,
    else 3; a chunk of as many tiles as make 256 KB of K and V (512
    positions at dh 64, 256 at dh 128), at least one and at most 64.
    bf16: 288 threads (a producer warp and 32 lane groups of eight
    lanes), a lane ⌈dh / 64⌉ 16-byte columns, 4 / that many positions a
    lane group a stage (a stage of 128, 64 or 32 positions), 2 stages
    and a chunk of 16 stages (2,048 positions at dh 64, 1,024 at dh 128,
    512 KB of K and V); the
    kernel's persistent blocks (`resident`) walk the grid's (chunk, row ·
    head block) units. Query
    heads in blocks of 1, 2 or 4. The chunk depends on dh and the
    operands' type alone, never on S, on the rows or on the row lengths,
    so views of any length, batches of any size and graph replays with
    new lengths cut the same chunks."""
    vec = decode_vector(itemsize) if itemsize in (2, 4) else 0
    if rows <= 0 or groups <= 0 or dh <= 0 or not vec or dh % vec:
        raise ValueError(f"decode_plan: rows {rows}, groups {groups} and "
                         f"head_dim {dh} must be positive, the itemsize 4 "
                         f"or 2 (got {itemsize}) and head_dim a multiple "
                         f"of {vec or 4}")
    ppg, tile, stages, tiles, head_block = decode_tiling(groups, dh,
                                                         itemsize)
    smem = decode_smem_bytes(ppg, stages, head_block, dh, itemsize)
    if smem > DECODE_SMEM_LIMIT:
        raise SmemBudgetError(
            f"decode_plan: head_dim {dh} needs {smem} bytes of shared "
            f"memory, past the {DECODE_SMEM_LIMIT} a block may take")
    threads = DECODE_BF16_THREADS if itemsize == 2 else DECODE_THREADS
    per_sm = min(DECODE_THREADS_PER_SM // threads,
                 DECODE_SMEM_PER_SM // (smem + DECODE_SMEM_RESERVED))
    return DecodePlan(
        rows=rows, groups=groups, dh=dh, itemsize=itemsize,
        chunk=tiles * tile, ppg=ppg,
        tile=tile, stages=stages, head_block=head_block,
        head_blocks=-(-groups // head_block), threads=threads,
        smem_bytes=smem, blocks_per_sm=per_sm)


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lens: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's function: q [B, 1, H, dh], k/v
    [B, S, K, dh], lens [B·K] int → [B, 1, H, dh] in q's dtype, over the
    whole cache in one pass (scores masked at positions ≥ len). bf16
    operands are computed in f32 and the output rounded to bf16 once,
    the kernel's contract."""
    if q.dtype == torch.bfloat16:
        return flash_decode_reference(q.float(), k.float(), v.float(),
                                      lens).to(q.dtype)
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


def flash_decode_split_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lens: torch.Tensor, *,
                                 chunk: int | None = None) -> torch.Tensor:
    """Plain version of the kernel in its split: each chunk of ``chunk``
    positions (`decode_plan`'s by default) that starts below its row's
    len forms its partial over its valid positions, m_c = max score,
    l_c = Σ e^{s − m_c}, acc_c = Σ e^{s − m_c}·v; the partials are
    combined in chunk order, M = max_c m_c, out = Σ_c e^{m_c − M}·acc_c /
    max(Σ_c e^{m_c − M}·l_c, 1e-30) (`DecodePlan.merge_order`). The bf16
    kernel folds its partials in this order (in base 2); the f32 kernel
    folds the same partials in another fixed order (`csrc/flash_decode.cu`);
    each agrees with this to the rounding of the sums. Shapes and dtypes
    as `flash_decode_reference` (bf16 in f32, the output rounded once)."""
    b, _, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    if chunk is None:
        chunk = decode_plan(b * kh, g, dh, q.element_size()).chunk
    if q.dtype == torch.bfloat16:
        return flash_decode_split_reference(
            q.float(), k.float(), v.float(), lens, chunk=chunk).to(q.dtype)
    n = -(-s // chunk)
    pad = n * chunk - s
    qg = q.reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) * dh ** -0.5
    length = lens.reshape(b, kh, 1, 1).to(torch.long)
    valid = torch.arange(s, device=q.device) < length
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    scores = F.pad(scores, (0, pad), value=_NEG_INF).reshape(b, kh, g, n,
                                                             chunk)
    vc = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(b, n, chunk, kh, dh)
    m_c = scores.amax(dim=-1)                                # [b, kh, g, n]
    p = torch.exp(scores - m_c[..., None])
    l_c = p.sum(dim=-1)
    acc_c = torch.einsum("bkgnc,bnckd->bkgnd", p, vc)
    active = torch.arange(n, device=q.device) * chunk < length  # [b, kh, 1, n]
    big_m = torch.where(active, m_c, _NEG_INF).amax(dim=-1)    # [b, kh, g]
    l = torch.zeros_like(big_m)
    acc = torch.zeros_like(acc_c[..., 0, :])
    for c in range(n):
        w = torch.where(active[..., c], torch.exp(m_c[..., c] - big_m), 0.0)
        l = l + w * l_c[..., c]
        acc = acc + w[..., None] * acc_c[..., c, :]
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, 1, h, dh)


_counters: dict[torch.device, torch.Tensor] = {}
_counters_lock = threading.Lock()


def _row_counters(device: torch.device, count: int) -> torch.Tensor:
    """The device's ticket table (uint32 as int32, zero between launches:
    each launch's last ticket wraps a counter back to 0), grown as rows
    need. Launches on one device share it, so they run on one stream at a
    time. It is made outside CUDA-graph capture: a capture's first launch
    on a device, or one with more rows than any launch before it, raises."""
    with _counters_lock:
        table = _counters.get(device)
        if table is None or table.numel() < count:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"flash_decode: the ticket table of {device} must be made "
                    f"before CUDA-graph capture: run flash_decode once "
                    f"outside the capture at {count} or more (batch, kv "
                    f"head) rows · head blocks first")
            table = torch.zeros(max(count, 1024), dtype=torch.int32,
                                device=device)
            _counters[device] = table
        return table


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lens: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked CUDA f32 or bf16 tensors of one type
    (q and out contiguous [B, 1, H, dh]; k/v [B, S, K, dh] with dh and
    the head axis contiguous, 16-byte aligned; lens [B·K] int32 in
    [1, S]), writing out on the current stream. The partials' workspace
    (f32) comes from `torch.empty`; the ticket table is the device's
    (`_row_counters`)."""
    b, _, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    plan = decode_plan(b * kh, h // kh, dh, q.element_size())
    ws = torch.empty(max(1, plan.workspace(s)), dtype=torch.float32,
                     device=q.device)
    counters = _row_counters(q.device, plan.counters)
    lib = _build.library("flash_decode")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                k.stride(0), k.stride(1), v.stride(0), v.stride(1), b)
    tiling = (kh, h // kh, dh, plan.ppg, plan.chunk, plan.chunks(s),
              plan.stages, plan.head_block, float(dh ** -0.5), stream)
    if q.dtype == torch.bfloat16:
        # and S, which bounds the tensor maps of the whole tiles
        code = lib.flash_decode_bf16(*pointers, s, *tiling)
    else:
        code = lib.flash_decode_f32(*pointers, *tiling)
    _build.check(code, f"flash_decode launch ({h // kh} query heads per "
                 f"kv head at head_dim {dh}, {plan.chunks(s)} chunks of "
                 f"{plan.chunk} positions)")
