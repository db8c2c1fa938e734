"""`MultiHDBSCAN`: sklearn-style front door over a :class:`FittedModel`, the
port of ``repro/api/estimator.py``.

``fit`` builds a ``FittedModel`` (``est.model_``) and every query delegates
to it; ``est.model_.select(mpts, policy)`` is the first-class query
surface.  The original per-level accessors (``labels_for`` /
``hierarchy_for`` / ``membership_for`` / ``probabilities_for``) remain as
deprecation shims, as in the reference: they answer as before but emit a
``FutureWarning`` pointing at the ``select`` surface.
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Sequence

import numpy as np

from ..core import multi, predict
from .model import FittedModel
from .selection import SelectionPolicy


@dataclasses.dataclass
class Membership:
    """Per-fitted-point view of one density level: labels + strengths."""

    mpts: int
    labels: np.ndarray         # (n,) int64, -1 = noise
    probabilities: np.ndarray  # (n,) float64 in [0, 1], 0 for noise
    lambdas: np.ndarray        # (n,) float64 departure lambda (0 for noise)


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"MultiHDBSCAN.{old} is deprecated and will be removed next release; use {new} instead",
        FutureWarning,
        stacklevel=3,
    )


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
    mesh : torch.distributed.device_mesh.DeviceMesh, optional
        A mesh of the fit's device type (``launch.mesh``), the same on
        every rank of its process group, each rank calling ``fit`` on the
        same X.  When its ``data`` axis has more than one rank, the
        row-parallel stages (kNN, exact lune scan, the per-mpts Borůvka
        range) shard over it; a one-rank mesh (or ``None``) runs the
        single-device path.
    plan : "auto" | "single" | "mesh" | engine.Plan
        Placement request, resolved once at ``fit`` against ``mesh``:
        "auto" shards iff the mesh is usable, "single" forces the local
        path, "mesh" raises rather than silently degrading.  Pass a
        pre-built ``engine.Plan`` to pin every chunk/tile size.
    max_cached_hierarchies : int, optional
        Bound on the per-(mpts, policy) extraction cache (LRU eviction);
        settable after ``fit`` too (the ``max_cached_hierarchies``
        property), ``None`` keeps every requested level.
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
        mesh=None,
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
        self.mesh = mesh
        self.plan = plan
        self._max_cached_hierarchies = max_cached_hierarchies
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
            mesh=self.mesh,
            plan=self.plan,
            max_cached_hierarchies=self._max_cached_hierarchies,
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

    # -- legacy internal surface (kept for compatibility) ------------------

    @property
    def max_cached_hierarchies(self) -> int | None:
        return self._max_cached_hierarchies

    @max_cached_hierarchies.setter
    def max_cached_hierarchies(self, value: int | None) -> None:
        if value is not None and value < 1:
            raise ValueError(f"max_cached_hierarchies must be >= 1 or None; got {value}")
        self._max_cached_hierarchies = value
        if self._model is not None:
            self._model.max_cached_hierarchies = value

    @property
    def _msts(self) -> multi.MultiMSTResult | None:
        return None if self._model is None else self._model.msts

    @property
    def _X(self) -> np.ndarray | None:
        return None if self._model is None else self._model.X

    @property
    def _linkage(self) -> multi.LinkageRange | None:
        return None if self._model is None else self._model._linkage

    @property
    def _hierarchy_cache(self) -> "collections.OrderedDict[int, multi.HierarchyResult]":
        """Legacy view of the model's cache: default-policy entries by mpts."""
        if self._model is None:
            return collections.OrderedDict()
        default = self._model.default_policy
        return collections.OrderedDict((mpts, h) for (mpts, pol), h in self._model._cache.items() if pol == default)

    @property
    def _walk_cache(self) -> dict[int, predict.WalkTable]:
        if self._model is None:
            return {}
        return self._model._walk_cache(self._model.default_policy)

    def _check_fitted(self) -> multi.MultiMSTResult:
        return self.model_.msts

    def _ensure_linkage(self) -> multi.LinkageRange:
        return self.model_._ensure_linkage()

    # -- deprecated per-level accessors (FutureWarning) --------------------

    def hierarchy_for(self, mpts: int) -> multi.HierarchyResult:
        """Deprecated: use ``est.model_.select(mpts).hierarchy``."""
        _deprecated("hierarchy_for(mpts)", "model_.select(mpts).hierarchy")
        return self.model_.hierarchy(mpts)

    def labels_for(self, mpts: int) -> np.ndarray:
        """Deprecated: use ``est.model_.select(mpts).labels``."""
        _deprecated("labels_for(mpts)", "model_.select(mpts).labels")
        return self.model_.hierarchy(mpts).labels

    def membership_for(self, mpts: int) -> Membership:
        """Deprecated: use ``est.model_.select(mpts)`` (same fields)."""
        _deprecated("membership_for(mpts)", "model_.select(mpts)")
        c = self.model_.select(mpts)
        return Membership(mpts=mpts, labels=c.labels, probabilities=c.probabilities, lambdas=c.lambdas)

    def probabilities_for(self, mpts: int) -> np.ndarray:
        """Deprecated: use ``est.model_.select(mpts).probabilities``."""
        _deprecated("probabilities_for(mpts)", "model_.select(mpts).probabilities")
        return self.model_.select(mpts).probabilities

    # -- stable query surface (delegates to the model) ----------------------

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
