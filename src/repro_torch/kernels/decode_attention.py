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
floored at 1e-30 before the divide.

The kernel (`csrc/flash_decode.cu`) splits each (batch, kv head) row's
positions into chunks of `decode_plan`'s length, a function of dh alone,
and runs one block per (row, head block, chunk): each block streams its
chunk through a cp.async ring in shared memory, and the last of a row's
active chunks merges their partials in chunk order
(`flash_decode_split_reference` is its plain version). The wrapper that
checks and dispatches is `repro_torch.kernels.ops.flash_decode`.
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_NEG_INF = -1e30

DECODE_THREADS = 256
DECODE_LANES = 8                  # lanes per position
DECODE_LANE_GROUPS = DECODE_THREADS // DECODE_LANES   # 32
DECODE_CHUNK_BYTES = 256 << 10    # K and V bytes a block streams
DECODE_MAX_CHUNK_TILES = 64
DECODE_PAIR_STAGE_BYTES = 32 << 10   # two positions a lane group up to it
DECODE_HEAD_BLOCKS = (1, 2, 4)    # query heads a block takes
DECODE_SMEM_LIMIT = 232_448       # shared memory a block may take
DECODE_SMEM_PER_SM = 233_472      # an SM's, of which 1 KB per block is
DECODE_SMEM_RESERVED = 1_024      # the system's
DECODE_THREADS_PER_SM = 2_048


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """Launch plan of `flash_decode` for ``rows`` (batch, kv head) rows of
    ``groups`` query heads at head size ``dh``. Every field is a function
    of (rows, groups, dh) alone: the cache length S and the row lengths
    only pick how many chunks a launch has and which of them run."""

    rows: int
    groups: int
    dh: int
    chunk: int          # positions per block, a multiple of `tile`
    ppg: int            # positions a lane group takes from a tile (1, 2)
    tile: int           # positions per ring stage, 32·ppg
    stages: int         # ring stages in shared memory (3 or 4)
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


@functools.lru_cache(maxsize=None)
def decode_plan(rows: int, groups: int, dh: int) -> DecodePlan:
    """Launch plan of `flash_decode`: 256 threads a block, eight lanes a
    position, so 32 lane groups; each takes two positions of a ring stage
    while such a stage (64 positions of K and V) is at most 32 KB
    (dh ≤ 64), else one; 4 stages while a stage is at most 16 KB, else 3;
    a chunk of as many tiles as make 256 KB of K and V (512 positions at
    dh 64, 256 at dh 128), at least one and at most 64; query heads in
    blocks of 1, 2 or 4. The chunk depends on dh alone, never on S or on
    the row lengths, so views of any length and graph replays with new
    lengths cut the same chunks."""
    if rows <= 0 or groups <= 0 or dh <= 0 or dh % 4:
        raise ValueError(f"decode_plan: rows {rows}, groups {groups} and "
                         f"head_dim {dh} must be positive, head_dim a "
                         f"multiple of 4")
    ppg = 2 if 2 * 2 * DECODE_LANE_GROUPS * dh * 4 \
        <= DECODE_PAIR_STAGE_BYTES else 1
    tile = ppg * DECODE_LANE_GROUPS
    stage_bytes = 2 * tile * dh * 4
    stages = 4 if stage_bytes <= 16 << 10 else 3
    tiles = max(1, min(DECODE_MAX_CHUNK_TILES,
                       DECODE_CHUNK_BYTES // stage_bytes))
    head_block = next((hb for hb in DECODE_HEAD_BLOCKS if hb >= groups),
                      DECODE_HEAD_BLOCKS[-1])
    smem = (stages * 2 * tile * dh + head_block * dh) * 4
    if smem > DECODE_SMEM_LIMIT:
        raise ValueError(f"decode_plan: head_dim {dh} needs {smem} bytes of "
                         f"shared memory, past the {DECODE_SMEM_LIMIT} a "
                         f"block may take")
    per_sm = min(DECODE_THREADS_PER_SM // DECODE_THREADS,
                 DECODE_SMEM_PER_SM // (smem + DECODE_SMEM_RESERVED))
    return DecodePlan(
        rows=rows, groups=groups, dh=dh, chunk=tiles * tile, ppg=ppg,
        tile=tile, stages=stages, head_block=head_block,
        head_blocks=-(-groups // head_block), threads=DECODE_THREADS,
        smem_bytes=smem, blocks_per_sm=per_sm)


def flash_decode_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           lens: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's function: q [B, 1, H, dh], k/v
    [B, S, K, dh], lens [B·K] int → [B, 1, H, dh] in q's dtype, over the
    whole cache in one pass (scores masked at positions ≥ len)."""
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
    max(Σ_c e^{m_c − M}·l_c, 1e-30). The kernel forms the same partials
    and folds them in another fixed order (`csrc/flash_decode.cu`), so the
    two agree to the rounding of the sums. Shapes as
    `flash_decode_reference`."""
    b, _, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    if chunk is None:
        chunk = decode_plan(b * kh, g, dh).chunk
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
    """Launch the kernel on checked CUDA f32 tensors (q and out
    contiguous [B, 1, H, dh]; k/v [B, S, K, dh] with dh and the head axis
    contiguous, 16-byte aligned; lens [B·K] int32 in [1, S]), writing out
    on the current stream. The partials' workspace comes from
    `torch.empty`; the ticket table is the device's (`_row_counters`)."""
    b, _, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    plan = decode_plan(b * kh, h // kh, dh)
    ws = torch.empty(max(1, plan.workspace(s)), dtype=torch.float32,
                     device=q.device)
    counters = _row_counters(q.device, plan.counters)
    lib = _build.library("flash_decode")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_decode_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), b, kh, h // kh, dh,
        plan.ppg, plan.chunk, plan.chunks(s), plan.stages,
        plan.head_block,
        float(dh ** -0.5), stream)
    _build.check(code, f"flash_decode launch ({h // kh} query heads per "
                 f"kv head at head_dim {dh}, {plan.chunks(s)} chunks of "
                 f"{plan.chunk} positions)")
