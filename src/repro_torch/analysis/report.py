"""Findings model and rendering for the `repro_torch.analysis` passes.

The port's own copy of the reference's `repro.analysis.report`. Every
pass (shared-memory budget, dispatch contract, conventions) reports
through the same `Finding` record, so the CLI can merge them into one
machine-readable JSON document or one human report, and tests can assert
on them uniformly.

Severity is two-valued on purpose: everything the passes check is a hard
house contract (tier-1 fails on any ``error``), and ``warning`` is
reserved for checks that are conservative by construction (e.g. the
replication analysis proving "not provably replicated" rather than
"provably divergent").
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    ``pass_name``: which pass produced it ("budget", "dispatch",
    "conventions").
    ``rule``: stable rule identifier (e.g. "V001", "J002", "R006") so tests
    and CI can match findings without string-scraping messages.
    ``where``: what was analyzed — a ``file:line`` for AST findings, an
    entry-point label like ``solve_batched[backend=cuda,tol=0]`` for
    dispatch findings, a kernel and shape for budget findings.
    """
    pass_name: str
    rule: str
    where: str
    message: str
    severity: str = "error"  # "error" | "warning"

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"[{self.rule}] {self.severity}: {self.where}: {self.message}"


def render_report(findings: Iterable[Finding], *,
                  title: str = "repro_torch.analysis") -> str:
    """Human-readable report: findings grouped by pass, errors first."""
    findings = list(findings)
    lines = [f"== {title} =="]
    if not findings:
        lines.append("clean: no findings")
        return "\n".join(lines)
    order = {"error": 0, "warning": 1}
    by_pass: dict[str, list[Finding]] = {}
    for f in findings:
        by_pass.setdefault(f.pass_name, []).append(f)
    for pass_name in sorted(by_pass):
        group = sorted(by_pass[pass_name],
                       key=lambda f: (order.get(f.severity, 2), f.rule,
                                      f.where))
        lines.append(f"-- {pass_name} ({len(group)}) --")
        lines.extend(f.render() for f in group)
    num_err = sum(1 for f in findings if f.severity == "error")
    num_warn = len(findings) - num_err
    lines.append(f"total: {num_err} error(s), {num_warn} warning(s)")
    return "\n".join(lines)


def render_json(findings: Iterable[Finding], *,
                extra: dict[str, Any] | None = None) -> str:
    """Machine-readable report (the CI job parses this)."""
    findings = list(findings)
    doc: dict[str, Any] = {
        "findings": [f.to_json() for f in findings],
        "num_errors": sum(1 for f in findings if f.severity == "error"),
        "num_warnings": sum(1 for f in findings
                            if f.severity == "warning"),
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=True)
