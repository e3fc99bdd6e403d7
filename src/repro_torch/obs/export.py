"""Exporters: JSONL from one `Registry`, plus run provenance.

The port's counterpart of the reference's `repro.obs.export`; for the
same registry contents both write the same JSONL. Its schema (one JSON
object per line, `kind` discriminated):

  {"kind": "provenance", "git_sha": ..., "torch_version": ...,
   "cuda_version": ..., "device_kind": ..., "platform": ...,
   "power_limit": ..., "plain": ..., "t_wall": ...}
  {"kind": "counter",   "name": ..., "value": ...}
  {"kind": "gauge",     "name": ..., "value": ...}
  {"kind": "histogram", "name": ..., "count": ..., "sum": ...,
   "mean": ..., "max": ..., "p50": ..., "p99": ...}
  {"kind": "span",      "name": ..., "t_start": ..., "t_end": ...,
   "depth": ..., "parent": ..., "thread": ..., "attrs": {...}}
  {"kind": "event",     "event": ..., "t": ..., ...free-form fields}

Reserved event names the report CLI (`python -m repro_torch.obs`)
renders specially: ``trace`` (convergence curve — fields `label`,
`residuals`, optionally `bytes`/`broadcasts`/`deliveries`/`active` from an
async trace) and ``latency`` (serve percentiles — fields `label` plus the
`LatencyReport` numbers). Everything else renders generically.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Any

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, LatencyReport,
                               Registry, wall_clock)

__all__ = [
    "latency_event",
    "provenance",
    "registry_lines",
    "stamp_provenance",
    "to_jsonl",
    "trace_event",
    "write_jsonl",
]


def _power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card), or None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def provenance(*, plain: bool | None = None, device: Any = None,
               extra: dict[str, Any] | None = None) -> dict[str, Any]:
    """Run-provenance block: git sha, torch and CUDA versions, the device
    (``device_kind``: the card's name, or ``"cpu"``; ``platform``:
    ``"gpu"`` or ``"cpu"``; ``power_limit``: nvidia-smi's name and power
    limit on the card, None elsewhere) and ``plain``, true where the
    kernels ran as their plain versions. ``device`` is the run's device
    (default: the card when there is one). Every probe is best-effort — a
    missing git checkout or nvidia-smi degrades to None, never raises."""
    sha = None
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        sha = None
    torch_version = cuda_version = None
    device_kind, platform, power_limit = "cpu", "cpu", None
    try:
        import torch

        torch_version = torch.__version__
        cuda_version = torch.version.cuda
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available()
            else torch.device("cpu"))
        if dev.type == "cuda":
            device_kind = torch.cuda.get_device_name(dev)
            platform = "gpu"
            power_limit = _power_limit()
    except (ImportError, RuntimeError, AssertionError):
        pass
    block = {
        "git_sha": sha,
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "device_kind": device_kind,
        "platform": platform,
        "power_limit": power_limit,
        "plain": plain,
        "t_wall": float(wall_clock()),
    }
    if extra:
        block.update(extra)
    return block


def trace_event(registry: Registry, label: str, trace: Any,
                **fields: Any) -> dict[str, Any]:
    """Record a solver convergence trace (`SolveTrace` /
    `AsyncSolveTrace`) as a ``trace`` event the report CLI renders as a
    convergence table (and, when wire fields are present, as a comm
    frontier row)."""
    return registry.record_event("trace", label=str(label),
                                 **trace.as_lists(), **fields)


def latency_event(registry: Registry, label: str,
                  report: LatencyReport) -> dict[str, Any]:
    """Record a `LatencyReport` as a ``latency`` event (per-wave serve
    percentiles section of the report CLI)."""
    return registry.record_event(
        "latency", label=str(label), count=report.count, p50=report.p50,
        p99=report.p99, mean=report.mean, max=report.max, qps=report.qps)


def registry_lines(registry: Registry,
                   prov: dict[str, Any] | None = None
                   ) -> list[dict[str, Any]]:
    """Serialize one registry to the JSONL record list."""
    lines: list[dict[str, Any]] = []
    if prov is not None:
        lines.append({"kind": "provenance", **prov})
    for name, m in sorted(registry.metrics.items()):
        if isinstance(m, Counter):
            lines.append({"kind": "counter", "name": name,
                          "value": m.value})
        elif isinstance(m, Gauge):
            lines.append({"kind": "gauge", "name": name, "value": m.value})
        elif isinstance(m, Histogram):
            lines.append({"kind": "histogram", "name": name,
                          **m.summary()})
    for sp in registry.spans:
        lines.append({"kind": "span", "name": sp.name,
                      "t_start": sp.t_start, "t_end": sp.t_end,
                      "depth": sp.depth, "parent": sp.parent,
                      "thread": sp.thread, "attrs": dict(sp.attrs)})
    for ev in registry.events:
        lines.append({"kind": "event", **ev})
    return lines


def to_jsonl(registry: Registry,
             prov: dict[str, Any] | None = None) -> str:
    return "\n".join(json.dumps(rec, sort_keys=True)
                     for rec in registry_lines(registry, prov)) + "\n"


def write_jsonl(registry: Registry, path: str,
                prov: dict[str, Any] | None = None) -> str:
    with open(path, "w") as f:
        f.write(to_jsonl(registry, prov))
    return path


def stamp_provenance(path: str,
                     prov: dict[str, Any] | None = None) -> bool:
    """Inject/refresh a ``provenance`` block in an existing bench JSON
    artifact (top-level dict or list — lists are wrapped under
    ``{"provenance": ..., "results": [...]}``). Returns False when the
    file is missing or unparseable (stamping is best-effort)."""
    if prov is None:
        prov = provenance()
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return False
    if isinstance(payload, dict):
        payload["provenance"] = prov
    else:
        payload = {"provenance": prov, "results": payload}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")
    return True
