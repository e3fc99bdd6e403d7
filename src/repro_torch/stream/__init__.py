"""Online / streaming DeKRR-DDRF runtime, the counterpart of
`repro.stream`.

Nodes ingest samples over time, fold them into the paper's quantities
incrementally, refresh their data-dependent features when the local
distribution drifts, and continue the consensus solve from the carried
iterate:

  `updates.py` — Eq. 17, incrementally: rank-b Woodbury updates of the
      per-node auxiliaries in the packed [J, D_max, …] layout of
      `repro_torch.dist.PackedProblem`; `refresh_node` rebuilds one
      node's slot after a feature-map change; `to_packed` materializes
      the live packed program; `repad_theta` carries Eq. 19 iterates
      across a layout change.
  `drift.py` — §III-B's DDRF selection scores as a drift statistic
      (total variation between the selection-time and a window's score
      distributions) and a threshold policy that triggers a refresh.
  `runtime.py` — Eq. 19, warm-started: `StreamingDeKRR` interleaves
      ingest → (maybe refresh) → consensus continuation on every backend
      ("torch", "cuda", "cuda_fused"; sync or async gossip), and exports
      θ snapshots with staleness bounds through `SnapshotRegistry` to
      the serving tier (`repro_torch.serve.dekrr`).

Exactness contract: after any ingest/refresh sequence, the stream state
equals a from-scratch `pack_problem` + solve on the accumulated data at
rtol 1e-9 in float64 (the ridge is pinned at stream start — see
`updates.py` and `reference_lam`).
"""
from repro_torch.stream.drift import DriftConfig, DriftDetector, DriftVerdict
from repro_torch.stream.runtime import (IngestReport, RefreshReport,
                                        ServeSnapshot, SnapshotRegistry,
                                        SolveReport, StalenessBound,
                                        StreamConfig, StreamingDeKRR)
from repro_torch.stream.updates import (StreamAux, ingest, init_stream_aux,
                                        reference_lam, refresh_node,
                                        repad_theta, to_packed)

__all__ = [
    "DriftConfig",
    "DriftDetector",
    "DriftVerdict",
    "IngestReport",
    "RefreshReport",
    "ServeSnapshot",
    "SnapshotRegistry",
    "SolveReport",
    "StalenessBound",
    "StreamAux",
    "StreamConfig",
    "StreamingDeKRR",
    "ingest",
    "init_stream_aux",
    "reference_lam",
    "refresh_node",
    "repad_theta",
    "to_packed",
]
