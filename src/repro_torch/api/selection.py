"""`SelectionPolicy`: how clusters are cut out of a condensed tree.

A copy of ``repro/api/selection.py`` (no JAX in it).

The fitted state (one shared graph, R mutual-reachability MSTs) is
selection-agnostic — excess-of-mass vs leaf selection, the epsilon
threshold of Malzer & Baum's hybrid method, ``allow_single_cluster``, and
``min_cluster_size`` only shape the *view* extracted from it.  This module
gives that family of knobs one frozen, hashable home so a policy can flow
uniformly through ``core.hierarchy`` extraction, ``FittedModel.select``,
``approximate_predict``, and per-request serve options, and so (mpts,
policy) pairs can key extraction caches.
"""

from __future__ import annotations

import dataclasses
import math

SELECTION_METHODS = ("eom", "leaf")


@dataclasses.dataclass(frozen=True)
class SelectionPolicy:
    """Frozen per-query cluster-selection configuration.

    Parameters
    ----------
    method : {"eom", "leaf"}
        Excess-of-mass (FOSC, the HDBSCAN* default) or condensed-tree
        leaves (many fine-grained clusters).
    epsilon : float
        Malzer & Baum's hybrid threshold (*A Hybrid Approach To
        Hierarchical Density-based Cluster Selection*): selected clusters
        born below this distance are merged upward into their first
        ancestor born at a distance >= epsilon, suppressing micro-clusters
        without giving up the hierarchy.  ``0.0`` (default) disables it.
    allow_single_cluster : bool
        Permit the condensed-tree root as a selected cluster.
    min_cluster_size : int, optional
        Condensation threshold.  ``None`` keeps the per-mpts default
        ``max(2, mpts)``.
    """

    method: str = "eom"
    epsilon: float = 0.0
    allow_single_cluster: bool = False
    min_cluster_size: int | None = None

    def __post_init__(self):
        if self.method not in SELECTION_METHODS:
            raise ValueError(
                f"method must be one of {SELECTION_METHODS}; got {self.method!r}"
            )
        eps = float(self.epsilon)
        if not (math.isfinite(eps) and eps >= 0.0):
            raise ValueError(
                f"epsilon must be a finite float >= 0; got {self.epsilon!r}"
            )
        object.__setattr__(self, "epsilon", eps)
        if self.min_cluster_size is not None and self.min_cluster_size < 2:
            raise ValueError(
                f"min_cluster_size must be >= 2 (or None for the per-mpts "
                f"default max(2, mpts)); got {self.min_cluster_size}"
            )

    def replace(self, **changes) -> "SelectionPolicy":
        """A copy with the given fields changed (re-validated)."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> dict:
        """JSON-serializable form (artifact headers)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SelectionPolicy":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def describe(self) -> str:
        parts = [self.method]
        if self.epsilon > 0.0:
            parts.append(f"eps={self.epsilon:g}")
        if self.allow_single_cluster:
            parts.append("single-ok")
        if self.min_cluster_size is not None:
            parts.append(f"mcs={self.min_cluster_size}")
        return "+".join(parts)
