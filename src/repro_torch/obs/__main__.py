"""Run-report CLI: ``python -m repro_torch.obs RUN.jsonl``.

The port's counterpart of the reference's `repro.obs.__main__`, with the
same sections. Renders a human-readable report from a JSONL file
produced by `repro_torch.obs.export.write_jsonl` (the bench runner
`python -m repro_torch.bench.run` writes one per run):
provenance header, convergence-curve table, comm frontier, span
waterfall, counters/gauges, and per-wave serve percentiles. Sections
with no matching records are omitted; an empty file still renders (and
exits 0) so the CI smoke is robust to reduced runs.

The report is pure text over recorded data: it runs nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any

_BAR_WIDTH = 40


def load_records(path: str) -> list[dict[str, Any]]:
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError as exc:
                raise SystemExit(
                    f"{path}:{lineno}: not a JSON record: {exc}")
    return records


def _fmt(v: float) -> str:
    return f"{v:.3e}"


def _section(title: str) -> str:
    return f"\n== {title} " + "=" * max(1, 60 - len(title))


def render_provenance(records: list[dict]) -> list[str]:
    provs = [r for r in records if r.get("kind") == "provenance"]
    if not provs:
        return []
    out = [_section("provenance")]
    for p in provs:
        for key in ("git_sha", "torch_version", "cuda_version",
                    "device_kind", "platform", "power_limit", "plain"):
            if p.get(key) is not None:
                out.append(f"  {key:<12} {p[key]}")
    return out


def _checkpoints(n: int) -> list[int]:
    """Round indices shown in the convergence table: first, quartiles,
    last (deduped, ordered)."""
    idx = [0, n // 4, n // 2, (3 * n) // 4, n - 1]
    return sorted({max(0, min(n - 1, i)) for i in idx})


def render_convergence(records: list[dict]) -> list[str]:
    traces = [r for r in records
              if r.get("kind") == "event" and r.get("event") == "trace"
              and r.get("residuals")]
    if not traces:
        return []
    out = [_section("convergence")]
    width = max(len(str(t.get("label", "?"))) for t in traces)
    for t in traces:
        res = [float(v) for v in t["residuals"]]
        cps = _checkpoints(len(res))
        cells = "  ".join(f"r{i + 1}={_fmt(res[i])}" for i in cps)
        out.append(f"  {str(t.get('label', '?')):<{width}}  "
                   f"rounds={len(res):<5d} {cells}")
    return out


def render_comm_frontier(records: list[dict]) -> list[str]:
    traces = [r for r in records
              if r.get("kind") == "event" and r.get("event") == "trace"
              and r.get("bytes")]
    if not traces:
        return []
    out = [_section("comm frontier"),
           f"  {'label':<28} {'rounds':>6} {'bytes':>12} "
           f"{'broadcasts':>10} {'deliveries':>10} {'final resid':>12}"]
    for t in traces:
        res = [float(v) for v in t.get("residuals", [])]
        out.append(
            f"  {str(t.get('label', '?')):<28} "
            f"{len(t['bytes']):>6d} {int(sum(t['bytes'])):>12d} "
            f"{int(sum(t.get('broadcasts', []))):>10d} "
            f"{int(sum(t.get('deliveries', []))):>10d} "
            f"{_fmt(res[-1]) if res else '-':>12}")
    return out


def render_spans(records: list[dict]) -> list[str]:
    spans = [r for r in records if r.get("kind") == "span"]
    if not spans:
        return []
    spans.sort(key=lambda s: (float(s["t_start"]), int(s.get("depth", 0))))
    t0 = min(float(s["t_start"]) for s in spans)
    t1 = max(float(s["t_end"]) for s in spans)
    total = max(t1 - t0, 1e-12)
    out = [_section("span waterfall"), f"  total {total:.4f}s"]
    for s in spans:
        start, end = float(s["t_start"]) - t0, float(s["t_end"]) - t0
        lo = int(_BAR_WIDTH * start / total)
        hi = max(lo + 1, int(_BAR_WIDTH * end / total))
        bar = " " * lo + "#" * (min(hi, _BAR_WIDTH) - lo)
        name = "  " * int(s.get("depth", 0)) + str(s["name"])
        out.append(f"  {name:<28.28} |{bar:<{_BAR_WIDTH}}| "
                   f"{end - start:>9.4f}s")
    return out


def render_metrics(records: list[dict]) -> list[str]:
    counters = [r for r in records if r.get("kind") == "counter"]
    gauges = [r for r in records if r.get("kind") == "gauge"]
    if not counters and not gauges:
        return []
    out = [_section("counters / gauges")]
    for r in counters + gauges:
        out.append(f"  {r['name']:<40} {r['value']:.6g}")
    return out


def render_latency(records: list[dict]) -> list[str]:
    evs = [r for r in records
           if r.get("kind") == "event" and r.get("event") == "latency"]
    hists = [r for r in records if r.get("kind") == "histogram"]
    if not evs and not hists:
        return []
    out = [_section("latency / percentiles"),
           f"  {'label':<32} {'count':>6} {'p50':>10} {'p99':>10} "
           f"{'mean':>10} {'max':>10} {'qps':>10}"]
    for r in evs:
        out.append(
            f"  {str(r.get('label', '?')):<32} {int(r['count']):>6d} "
            f"{_fmt(r['p50']):>10} {_fmt(r['p99']):>10} "
            f"{_fmt(r['mean']):>10} {_fmt(r['max']):>10} "
            f"{r['qps']:>10.2f}")
    for r in hists:
        out.append(
            f"  {str(r['name']):<32} {int(r['count']):>6d} "
            f"{_fmt(r['p50']):>10} {_fmt(r['p99']):>10} "
            f"{_fmt(r['mean']):>10} {_fmt(r['max']):>10} {'-':>10}")
    return out


def render_report(records: list[dict]) -> str:
    out: list[str] = ["obs run report"]
    out += render_provenance(records)
    out += render_convergence(records)
    out += render_comm_frontier(records)
    out += render_spans(records)
    out += render_metrics(records)
    out += render_latency(records)
    if len(out) == 1:
        out.append("  (no records)")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render a run report from an obs JSONL file.")
    parser.add_argument("jsonl", help="path to a run JSONL "
                        "(repro_torch.obs.export.write_jsonl output)")
    args = parser.parse_args(argv)
    print(render_report(load_records(args.jsonl)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
