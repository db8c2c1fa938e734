"""`MultiHDBSCAN`: sklearn-style front door over a :class:`FittedModel`, the
port of ``repro/api/estimator.py``.

``fit`` builds a ``FittedModel`` (``est.model_``) and every query delegates
to it.  The reference's deprecated per-level accessors (``labels_for`` and
friends) are not ported; ``est.model_.select(mpts)`` replaces them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import multi
from .model import FittedModel
from .selection import SelectionPolicy


class MultiHDBSCAN:
    """All HDBSCAN* hierarchies for mpts in [kmin, kmax] from one fit.

    Parameters
    ----------
    kmax : int
        Largest mpts in the range; one (kmax-1)-NN pass and one RNG^kmax
        serve the whole range.
    kmin : int
        Smallest mpts in the range (default 2).
    mpts_values : sequence of int, optional
        Explicit subset of the range (default: all of [kmin, kmax]).
    min_cluster_size : int, optional
        Condensation threshold; default per-mpts ``max(2, mpts)``.
    cluster_selection_method : {"eom", "leaf"}
    cluster_selection_epsilon : float
        Malzer & Baum's hybrid threshold; 0.0 (default) disables it.
    allow_single_cluster : bool
    variant : {"rng_ss", "rng_star", "rng"}
        RNG^kmax graph variant: ``"rng_star"`` (default) filters the WSPD
        supergraph with the kNN-lune check and the core-distance
        certificate; ``"rng"`` adds the exact lune scan of the edges left
        unresolved (the ``lune_filter`` kernel on the card).
    device : str or torch.device, optional
        Where the fit runs.  Default ``"cuda"``: the hand-written kernels,
        and a ``RuntimeError`` on a machine without a card.  ``"cpu"`` runs
        their plain PyTorch versions.
    plan : "auto" | "single" | engine.Plan
        Pass a pre-built ``engine.Plan`` to pin every chunk/tile size.
    max_cached_hierarchies : int, optional
        Bound on the per-(mpts, policy) extraction cache (LRU eviction).
    """

    def __init__(
        self,
        kmax: int = 16,
        *,
        kmin: int = 2,
        mpts_values: Sequence[int] | None = None,
        min_cluster_size: int | None = None,
        cluster_selection_method: str = "eom",
        cluster_selection_epsilon: float = 0.0,
        allow_single_cluster: bool = False,
        variant: str = "rng_star",
        device=None,
        plan="auto",
        max_cached_hierarchies: int | None = None,
    ):
        if cluster_selection_method not in ("eom", "leaf"):
            raise ValueError(
                "cluster_selection_method must be 'eom' or 'leaf'; "
                f"got {cluster_selection_method!r}"
            )
        if kmax < 2:
            raise ValueError(f"kmax must be >= 2; got {kmax}")
        multi._validate_min_cluster_size(min_cluster_size)
        if not 2 <= kmin <= kmax:
            raise ValueError(f"need 2 <= kmin <= kmax; got kmin={kmin}, kmax={kmax}")
        if max_cached_hierarchies is not None and max_cached_hierarchies < 1:
            raise ValueError(
                f"max_cached_hierarchies must be >= 1 or None; got {max_cached_hierarchies}"
            )
        self.kmax = kmax
        self.kmin = kmin
        self.mpts_values = list(mpts_values) if mpts_values is not None else None
        self.min_cluster_size = min_cluster_size
        self.cluster_selection_method = cluster_selection_method
        self.cluster_selection_epsilon = cluster_selection_epsilon
        self.allow_single_cluster = allow_single_cluster
        self.variant = variant
        self.device = device
        self.plan = plan
        self.max_cached_hierarchies = max_cached_hierarchies
        self._model: FittedModel | None = None
        # eager policy construction: bad selection knobs fail here, not at fit
        self._selection_policy()

    def _selection_policy(self) -> SelectionPolicy:
        return SelectionPolicy(
            method=self.cluster_selection_method,
            epsilon=self.cluster_selection_epsilon,
            allow_single_cluster=self.allow_single_cluster,
            min_cluster_size=self.min_cluster_size,
        )

    # -- fitting -----------------------------------------------------------

    def fit(self, X) -> "MultiHDBSCAN":
        """Compute the shared graph and every per-mpts MST (no extraction)."""
        # clear every fitted (trailing-underscore) attribute of a prior fit
        # first, so a failed refit cannot leave a half-stale estimator
        for name in [k for k in list(vars(self)) if k.endswith("_") and not k.startswith("_")]:
            delattr(self, name)
        self._model = None
        self._model = FittedModel.fit(
            X,
            self.kmax,
            kmin=self.kmin,
            mpts_values=self.mpts_values,
            policy=self._selection_policy(),
            variant=self.variant,
            device=self.device,
            plan=self.plan,
            max_cached_hierarchies=self.max_cached_hierarchies,
        )
        self.plan_ = self._model.plan
        self.n_features_in_ = self._model.n_features
        self.n_samples_ = self._model.n_samples
        self.mpts_values_ = self._model.mpts_values
        self.timings_ = dict(self._model.msts.timings)
        return self

    def fit_predict(self, X, mpts: int | None = None) -> np.ndarray:
        """fit + labels at one density level (default: the largest, kmax)."""
        self.fit(X)
        labels = self.model_.select(mpts if mpts is not None else self.mpts_values_[-1]).labels
        self.labels_ = labels
        return labels

    # -- queries -----------------------------------------------------------

    @property
    def model_(self) -> FittedModel:
        """The fitted artifact: ``select`` / ``select_all`` / ``save`` live here."""
        if self._model is None:
            raise RuntimeError("MultiHDBSCAN instance is not fitted yet; call fit(X)")
        return self._model

    def select(self, mpts: int, policy: SelectionPolicy | None = None):
        """The :class:`~repro_torch.api.model.Clustering` view at one level."""
        return self.model_.select(mpts, policy)

    def select_all(self, policy: SelectionPolicy | None = None):
        """Every fitted density level."""
        return self.model_.select_all(policy)

    def save(self, path: str) -> str:
        """Persist the fitted state as an artifact (``FittedModel.save``)."""
        return self.model_.save(path)

    def approximate_predict(self, Q, mpts: int | None = None, policy: SelectionPolicy | None = None):
        """Assign unseen points to the fitted clusters, no refit.

        With ``mpts`` given: ``(labels, probabilities)`` at that density
        level (McInnes & Healy's ``approximate_predict``).  With
        ``mpts=None``: a :class:`~repro_torch.core.predict.PredictResult`
        with (R, q) labels / probabilities / lambdas / neighbours for every
        fitted level from one query pass.
        """
        return self.model_.approximate_predict(Q, mpts, policy)

    def dbcv_profile(self) -> list[dict]:
        """DBCV relative validity per fitted mpts (paper §I): pick promising
        density levels without ground truth.  Returns
        ``[{"mpts", "dbcv", "n_clusters"}]``."""
        return self.model_.dbcv_profile()

    def mst_for(self, mpts: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ea, eb, w) MST edges under mutual reachability at this mpts."""
        return self.model_.mst(mpts)

    @property
    def graph_(self):
        """The fitted RNG^kmax (RngGraph: edges, d2, variant, stats)."""
        return self.model_.graph

    @property
    def n_graph_edges_(self) -> int:
        return self.model_.n_graph_edges

    def mpts_profile(self) -> list[dict]:
        """One summary row per density level (see ``FittedModel.mpts_profile``)."""
        return self.model_.mpts_profile()

    def __repr__(self) -> str:
        fitted = "" if self._model is None else f", fitted n={self.n_samples_}"
        place = f", plan={self.plan_.describe()}" if getattr(self, "plan_", None) is not None else ""
        return (
            f"MultiHDBSCAN(kmax={self.kmax}, kmin={self.kmin}, "
            f"variant={self.variant!r}, "
            f"cluster_selection_method={self.cluster_selection_method!r}"
            f"{place}{fitted})"
        )
