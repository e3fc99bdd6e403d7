"""Paper core of the port: graphs, random features, DDRF selection, the
ragged reference solver, the paper's baselines (centralized KRR and RF,
DKLA, DKLA-DDRF), metrics, and the asynchronous-gossip schedule with its
ragged solver. Chebyshev acceleration is
`repro_torch.core.acceleration` (it runs on the packed runtime)."""
from repro_torch.core.async_gossip import (AsyncGossipConfig,
                                           AsyncGossipResult,
                                           activation_masks,
                                           async_gossip_solve,
                                           censor_schedule, edge_list,
                                           edges_from_slot_table)
from repro_torch.core.baselines import (CentralizedKRR, CentralizedRF, DKLA,
                                        DKLAConfig, dkla_ddrf_feature_map)
from repro_torch.core.ddrf import (energy_scores, leverage_scores,
                                   select_features)
from repro_torch.core.dekrr import (AuxMatrices, DeKRRConfig, DeKRRSolver,
                                    DeKRRState, NodeData,
                                    prop1_required_c_self)
from repro_torch.core.graph import (Topology, circulant, complete,
                                    erdos_renyi, ring, star)
from repro_torch.core.metrics import mse, rse
from repro_torch.core.rff import (FeatureMap, featurize, gaussian_kernel,
                                  sample_rff)

__all__ = [
    "AsyncGossipConfig", "AsyncGossipResult", "activation_masks",
    "async_gossip_solve", "censor_schedule", "edge_list",
    "edges_from_slot_table",
    "AuxMatrices", "CentralizedKRR", "CentralizedRF", "DKLA", "DKLAConfig",
    "DeKRRConfig", "DeKRRSolver", "DeKRRState",
    "FeatureMap", "NodeData", "Topology", "circulant", "complete",
    "dkla_ddrf_feature_map", "energy_scores", "erdos_renyi", "featurize", "gaussian_kernel",
    "leverage_scores", "mse", "prop1_required_c_self", "ring", "rse",
    "sample_rff", "select_features", "star",
]
