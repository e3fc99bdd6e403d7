"""The fused RFF + Gram build (``rff_gram``) at paper-scale shapes: the
counterpart of `benchmarks/kernel_bench.py`.

    python -m repro_torch.bench.kernel_bench [--fast] [--out PATH] \
        [--device cpu]

At the reference's CASES (D_feat, d_in, N), in float32 at B 1 (all three
on the kernel's cluster route: F ≤ 1,024 in f32), on inputs drawn by a
seeded `torch.Generator` with the reference's distributions. On the card
three things are timed by CUDA events (`bench.common.event_ms`): the
hand-written kernel through `kernels.ops.rff_gram`, its plain version
(`kernels.ref.rff_gram_ref`, Z materialised) and the PyTorch yardstick
``cos(baddbmm)·scale`` then ``bmm``. On the CPU only the plain version
runs (host clock), and the provenance says ``plain``.

`analytic` keeps the reference's FLOP and byte formulas. The reference's
TPU terms are replaced by the card's: ``h100_bound_us`` = max(FLOPs / 67
TFLOP/s (f32 outside the tensor cores), bytes / 3.35 TB/s), and the
shared memory a block of the launch (`analysis.smem.estimate_rff_gram`)
against the opt-in limit (``fits_smem``) in place of VMEM.
"""
from __future__ import annotations

import math
import sys

import torch

from repro_torch._device import resolve_device
from repro_torch.analysis.smem import SMEM_OPTIN_PER_BLOCK, estimate_rff_gram
from repro_torch.bench.common import (H100_BYTES_PER_S, H100_FLOPS, cli,
                                      device_name, event_ms, time_us,
                                      write_json)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rff_gram_ref
from repro_torch.paper.common import csv_row

CASES = [
    # (D_feat, d_in, N) — paper-scale Gram builds
    (100, 8, 10000),
    (200, 148, 30000),
    (512, 96, 30000),
]
DTYPE = torch.float32


def analytic(d_feat: int, d_in: int, n: int, dtype_bytes: int = 4):
    """(flops, bytes, smem bytes a block, arithmetic intensity, the H100
    bound in s): the reference's FLOP and byte formulas (projection and
    Gram; x, Ω and G moved once), the card's bound and budget."""
    flops = 2 * d_feat * d_in * n + 2 * d_feat * d_feat * n  # proj + gram
    hbm = (d_in * n + d_feat * d_in + d_feat * d_feat) * dtype_bytes
    smem = estimate_rff_gram(b=1, f=d_feat, dim=d_in, n=n,
                             itemsize=dtype_bytes).bytes
    bound_s = max(flops / H100_FLOPS[DTYPE], hbm / H100_BYTES_PER_S)
    return flops, hbm, smem, flops / hbm, bound_s


def operands(d_feat: int, d_in: int, n: int, device, seed: int = 0):
    """(Ω [D, d], b [D], X [d, N], y [N]) in f32 with the reference's
    distributions: Ω, y normal, b, X uniform on [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=DTYPE, device=device, generator=gen)
    return (torch.randn((d_feat, d_in), **kw), torch.rand((d_feat,), **kw),
            torch.rand((d_in, n), **kw), torch.randn((n,), **kw))


def yardstick(omega, bias, x, y, scale):
    """The PyTorch yardstick: Z = cos(baddbmm)·scale, then bmm."""
    z = torch.cos(torch.baddbmm(bias[None, :, None], omega[None],
                                x[None])) * scale
    return torch.bmm(z, z.transpose(1, 2))[0], torch.bmm(z, y[None, :, None])[
        0, :, 0]


def case_row(d_feat: int, d_in: int, n: int, *, device, reps: int) -> dict:
    """One case: the analytic terms and, on the card, kernel, plain and
    yardstick ms by CUDA events; on the CPU the plain version's ms on the
    host clock."""
    om, bi, x, y = operands(d_feat, d_in, n, device)
    scale = math.sqrt(2.0 / d_feat)
    flops, hbm, smem, ai, bound_s = analytic(d_feat, d_in, n)
    row = {"name": f"kernel/rff_gram/D{d_feat}_d{d_in}_N{n}",
           "shape": [d_feat, d_in, n], "flops": flops, "hbm_bytes": hbm,
           "smem_bytes": smem, "fits_smem": smem <= SMEM_OPTIN_PER_BLOCK,
           "arith_intensity": ai, "h100_bound_us": bound_s * 1e6}

    def plain():
        return rff_gram_ref(om, bi, x, y, scale=scale)

    if device.type == "cuda":
        row.update(
            ms=event_ms(lambda: ops.rff_gram(om, bi, x, y, scale=scale),
                        reps=reps),
            plain_ms=event_ms(plain, reps=reps),
            library_ms=event_ms(lambda: yardstick(om, bi, x, y, scale),
                                reps=reps))
    else:
        row.update(ms=None, library_ms=None,
                   plain_ms=time_us(plain, reps, device) / 1e3)
    return row


def run(fast: bool = False, *, out: str | None = None, device=None,
        registry=None, cases=None) -> dict:
    """The benchmark over ``cases`` (default CASES, the first alone with
    ``fast``); returns the results and writes them as JSON to ``out``
    when given."""
    device = resolve_device(device)
    cases = cases or (CASES[:1] if fast else CASES)
    rows = []
    for d_feat, d_in, n in cases:
        row = case_row(d_feat, d_in, n, device=device,
                       reps=3 if fast else 20)
        rows.append(row)
        timed = row["ms"] if row["ms"] is not None else row["plain_ms"]
        csv_row(row["name"], timed * 1e3,
                f"flops={row['flops']:.2e};hbm_bytes={row['hbm_bytes']:.2e};"
                f"smem={row['smem_bytes'] / 2**10:.1f}KiB;"
                f"arith_intensity={row['arith_intensity']:.1f};"
                f"h100_bound_us={row['h100_bound_us']:.1f};"
                f"fits_smem={row['fits_smem']}"
                + ("" if row["ms"] is None else
                   f";plain_us={row['plain_ms'] * 1e3:.1f};"
                   f"yardstick_us={row['library_ms'] * 1e3:.1f}"))
        if registry is not None:
            registry.gauge(f"kernel.rff_gram.D{d_feat}_d{d_in}_N{n}.us"
                           ).set(timed * 1e3)
    results = {"benchmark": ("fused RFF + Gram build (rff_gram, f32, B 1): "
                             "kernel, plain version and yardstick beside "
                             "the H100 bound"),
               "device": device_name(device),
               "plain": device.type != "cuda", "rows": rows}
    if out is not None:
        write_json(results, out)
        print(f"kernel/json,0.0,wrote={out}")
    return results


if __name__ == "__main__":
    sys.exit(cli(run, __doc__))
