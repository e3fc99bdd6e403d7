"""Serving tier of the port: replicated, latency-accounted,
precision-bounded answers from a fitted DeKRR model.

    SnapshotRegistry ──latest()──▶ DeKRRReplicaServer (N replica threads)
      (repro_torch.stream:            │  per wave: stage the snapshot once
       immutable versioned            │  per version → featurize once per
       ServeSnapshots)                │  node (the rff_features kernel) →
                                      ▼  GEMVs → owned-copy answers
    queries ──validate(uid)──▶ AdmissionQueue ──take_wave──▶ replicas
                               (FIFO, slot + column budgets,
                                pad_bucket shapes)

  * `DeKRRServeEngine` — one engine over a snapshot source (a frozen
    `ServeSnapshot` or a `SnapshotRegistry`).
  * `DeKRRReplicaServer` — N engine replicas off one registry and one
    admission queue.

Every answer carries its snapshot's `StalenessBound`; on the
mixed-precision paths (precision="bf16"/"int8") its `precision` term
bounds |f_served − f_hi(θ)| (see `repro_torch.serve.dekrr`).
"""
from repro_torch.serve.admission import (Admitted, AdmissionQueue,
                                         LatencyRecorder, LatencyReport,
                                         pad_bucket)
from repro_torch.serve.dekrr import (DeKRRReplicaServer, DeKRRServeEngine,
                                     KernelQuery, answer_wave,
                                     stage_snapshot)

__all__ = [
    "Admitted",
    "AdmissionQueue",
    "DeKRRReplicaServer",
    "DeKRRServeEngine",
    "KernelQuery",
    "LatencyRecorder",
    "LatencyReport",
    "answer_wave",
    "pad_bucket",
    "stage_snapshot",
]
