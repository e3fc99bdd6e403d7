"""Paper core of the port: graphs, random features, DDRF selection, the
ragged reference solver and metrics."""
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
    "AuxMatrices", "DeKRRConfig", "DeKRRSolver", "DeKRRState",
    "FeatureMap", "NodeData", "Topology", "circulant", "complete",
    "energy_scores", "erdos_renyi", "featurize", "gaussian_kernel",
    "leverage_scores", "mse", "prop1_required_c_self", "ring", "rse",
    "sample_rff", "select_features", "star",
]
