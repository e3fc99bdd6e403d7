"""Telemetry containers of the port (slice 1: `SolveTrace` only)."""
from repro_torch.obs.trace import SolveTrace

__all__ = ["SolveTrace"]
