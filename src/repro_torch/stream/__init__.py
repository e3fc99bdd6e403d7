"""The serving contract of the online runtime (`runtime.py`): the
staleness-and-precision bound every answer carries, the immutable θ
snapshot the serving tier answers from, and the versioned registry that
publishes snapshots to serving replicas. The online event loop
(`StreamingDeKRR`, Woodbury ingest, drift) is the streaming slice's."""
from repro_torch.stream.runtime import (ServeSnapshot, SnapshotRegistry,
                                        StalenessBound)

__all__ = ["ServeSnapshot", "SnapshotRegistry", "StalenessBound"]
