"""Telemetry containers of the port: the convergence traces."""
from repro_torch.obs.trace import AsyncSolveTrace, SolveTrace

__all__ = ["AsyncSolveTrace", "SolveTrace"]
