"""Per-node distribution-drift detection on the DDRF scores.

The counterpart of `repro.stream.drift`. When a node's local distribution
drifts, the scores that justified its selected frequencies go stale, and
the node should re-run DDRF selection. The statistic lives on the scores
the selection already uses: normalize the score vector of the node's
selected frequencies into a distribution, and compare the reference
distribution (scored on the data the features were selected against)
with the same frequencies re-scored on a window of freshly ingested
samples, by total-variation distance

    drift(j) = ½ · Σ_k | ŝ_ref(k) − ŝ_window(k) |   ∈ [0, 1].

Energy scores (`repro_torch.core.ddrf.energy_scores`) use the labels;
leverage scores are the unsupervised family. A `threshold` policy turns
the statistic into a refresh trigger; windows must reach `min_samples`
before a verdict, so a single tiny minibatch cannot fire it.

`DriftDetector` is bookkeeping only and never touches solver state; the
`repro_torch.stream.runtime.StreamingDeKRR` event loop consumes its
verdicts and performs the `refresh_node` rebuild. Windows are kept as
chunk lists of tensors on the data's device; the statistic itself is
one host read per verdict.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ddrf import energy_scores, leverage_scores
from repro_torch.core.rff import FeatureMap
from repro_torch.stream.updates import _as_tensor

__all__ = ["DriftConfig", "DriftDetector", "DriftVerdict"]

_SCORE_FAMILIES = ("energy", "leverage")


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Threshold policy for score-drift refresh triggering.

    Attributes:
      score:        which DDRF score family to compare ("energy" uses the
                    labels, "leverage" is unsupervised).
      threshold:    total-variation trigger level in (0, 1]; a refresh is
                    recommended when the window statistic exceeds it.
      min_samples:  minimum window size before a verdict is issued —
                    smaller windows keep accumulating.
      leverage_lam: ridge for the leverage family.
    """

    score: str = "energy"
    threshold: float = 0.25
    min_samples: int = 64
    leverage_lam: float = 1e-6

    def __post_init__(self):
        if self.score not in _SCORE_FAMILIES:
            raise ValueError(f"score must be one of {_SCORE_FAMILIES}, "
                             f"got {self.score!r}")
        if not 0.0 < self.threshold <= 1.0:
            raise ValueError(f"threshold must be in (0, 1], "
                             f"got {self.threshold}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, "
                             f"got {self.min_samples}")


@dataclasses.dataclass(frozen=True)
class DriftVerdict:
    """One drift evaluation: the statistic (None while the window is still
    filling) and whether the policy recommends a refresh."""

    stat: float | None
    refresh: bool
    window_samples: int


class DriftDetector:
    """Tracks one score-distribution reference per node plus a window of
    pending ingested samples, and issues `DriftVerdict`s."""

    def __init__(self, feature_maps, data, config: DriftConfig):
        self.config = config
        self._fmaps = list(feature_maps)
        self._ref = [self._normalized_scores(fm, nd.x, nd.y)
                     for fm, nd in zip(self._fmaps, data)]
        j = len(self._fmaps)
        self._win_x: list[list[torch.Tensor]] = [[] for _ in range(j)]
        self._win_y: list[list[torch.Tensor]] = [[] for _ in range(j)]

    # -- scoring ------------------------------------------------------------
    def _normalized_scores(self, fmap: FeatureMap, x, y) -> np.ndarray:
        x = _as_tensor(x, device=fmap.omega.device)
        if self.config.score == "energy":
            y = _as_tensor(y, device=x.device).reshape(-1)
            s = energy_scores(fmap, x, y)
        else:
            s = leverage_scores(fmap, x, lam=self.config.leverage_lam)
        s = np.maximum(s.detach().cpu().numpy().astype(np.float64), 0.0)
        total = s.sum()
        if total <= 0.0:
            return np.full(s.shape, 1.0 / s.shape[0])
        return s / total

    # -- event-loop hooks ---------------------------------------------------
    def observe(self, node: int, xb, yb) -> DriftVerdict:
        """Fold one ingested minibatch into node's window; evaluate the
        drift statistic once the window reaches `min_samples` (the window
        then resets, so successive verdicts use disjoint data)."""
        j = int(node)
        device = self._fmaps[j].omega.device
        self._win_x[j].append(_as_tensor(xb, device=device))
        self._win_y[j].append(_as_tensor(yb, device=device).reshape(-1))
        n_win = sum(x.shape[1] for x in self._win_x[j])
        if n_win < self.config.min_samples:
            return DriftVerdict(stat=None, refresh=False,
                                window_samples=n_win)
        x = torch.cat(self._win_x[j], dim=1)
        y = torch.cat(self._win_y[j])
        self._win_x[j].clear()
        self._win_y[j].clear()
        win = self._normalized_scores(self._fmaps[j], x, y)
        stat = float(0.5 * np.abs(self._ref[j] - win).sum())
        return DriftVerdict(stat=stat,
                            refresh=stat > self.config.threshold,
                            window_samples=n_win)

    def rebase(self, node: int, fmap: FeatureMap, x, y) -> None:
        """Reset node's reference after a feature refresh: re-score the
        new frequencies on the accumulated data and clear the window."""
        j = int(node)
        self._fmaps[j] = fmap
        self._ref[j] = self._normalized_scores(fmap, x, y)
        self._win_x[j].clear()
        self._win_y[j].clear()
