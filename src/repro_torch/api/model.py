"""`FittedModel`: the fitted multi-hierarchy state as an artifact, the port
of ``repro/api/model.py``.

  * ``FittedModel.fit(X, kmax=..., device=...)`` — the one device-heavy step;
  * ``model.select(mpts, policy)`` — a :class:`Clustering` view, cached per
    (mpts, policy);
  * ``model.select_all(policy)`` — every fitted density level;
  * ``model.approximate_predict(Q, ...)`` — out-of-sample assignment, no
    refit; ``model.dbcv_profile()`` — DBCV at every level;
  * ``model.save(path)`` / ``FittedModel.load(path)`` — one ``.npz`` in the
    reference's format (``repro.fitted_model``, schema v1), so an artifact
    saved by either package loads in the other.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from .. import engine
from ..core import dbcv as dbcv_mod
from ..core import multi, predict
from .selection import SelectionPolicy

ARTIFACT_SCHEMA_VERSION = 1
_ARTIFACT_FORMAT = "repro.fitted_model"


class ArtifactError(RuntimeError):
    """A FittedModel artifact could not be read: corrupted file, wrong or
    missing header, schema-version mismatch, or config mismatch."""


def _config_hash(config: dict) -> str:
    return hashlib.sha256(json.dumps(config, sort_keys=True).encode()).hexdigest()[:16]


def _git_sha() -> str:
    """HEAD sha of the repo that contains this package, else "unknown"."""
    import subprocess

    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    if f"{os.sep}site-packages{os.sep}" in pkg_dir:
        return "unknown"
    try:
        top = subprocess.run(
            ["git", "-C", pkg_dir, "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        if not top or not pkg_dir.startswith(os.path.abspath(top) + os.sep):
            return "unknown"
        out = subprocess.run(
            ["git", "-C", pkg_dir, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _exemplars(h: multi.HierarchyResult) -> list[np.ndarray]:
    """Most-persistent point ids per selected cluster (hdbscan-style).

    For each selected cluster, take the leaf clusters of its condensed
    subtree and, within each leaf, the points that survive to the leaf's
    deepest departure lambda — the density peaks the cluster is "about".
    """
    tree = h.condensed
    n = tree.n_points
    cluster_rows = tree.child >= n
    kids: dict[int, list[int]] = {}
    for p, c in zip(tree.parent[cluster_rows], tree.child[cluster_rows]):
        kids.setdefault(int(p), []).append(int(c))
    pt_parent = tree.parent[~cluster_rows]
    pt_child = tree.child[~cluster_rows]
    pt_lam = tree.lam[~cluster_rows]

    out: list[np.ndarray] = []
    for c in sorted(h.selected):
        leaves: list[int] = []
        stack = [int(c)]
        while stack:
            v = stack.pop()
            ch = kids.get(v)
            if ch:
                stack.extend(ch)
            else:
                leaves.append(v)
        picks = []
        for leaf in leaves:
            rows = pt_parent == leaf
            if rows.any():
                lam = pt_lam[rows]
                finite = np.isfinite(lam)
                cap = lam[finite].max() if finite.any() else lam.max()
                picks.append(pt_child[rows][lam >= cap])
        out.append(np.sort(np.concatenate(picks)) if picks else np.empty(0, np.int64))
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Clustering:
    """One density level under one selection policy: a cheap query view."""

    mpts: int
    policy: SelectionPolicy
    hierarchy: multi.HierarchyResult = dataclasses.field(repr=False)

    @property
    def labels(self) -> np.ndarray:
        """(n,) int64 cluster labels of the fitted points; -1 = noise."""
        return self.hierarchy.labels

    @property
    def n_clusters(self) -> int:
        return self.hierarchy.n_clusters

    @property
    def lambdas(self) -> np.ndarray:
        """(n,) departure lambda of each fitted point (0 for noise)."""
        return np.asarray(self.hierarchy.point_lambda)

    @property
    def condensed_tree(self):
        return self.hierarchy.condensed

    @property
    def stability(self) -> dict[int, float]:
        return self.hierarchy.stability

    @property
    def selected(self) -> list[int]:
        """Selected condensed-cluster ids (sorted order = label order)."""
        return self.hierarchy.selected

    @functools.cached_property
    def probabilities(self) -> np.ndarray:
        """(n,) hdbscan-style membership strength in [0, 1] (0 = noise)."""
        return predict.membership_probabilities(self.hierarchy)

    @functools.cached_property
    def exemplars(self) -> list[np.ndarray]:
        """Per-label arrays of the most-persistent point ids (density peaks)."""
        return _exemplars(self.hierarchy)

    def __repr__(self) -> str:
        return (
            f"Clustering(mpts={self.mpts}, n_clusters={self.n_clusters}, "
            f"policy={self.policy.describe()!r})"
        )


class FittedModel:
    """Immutable fitted artifact: one graph, all hierarchies, cheap views.

    Build with :meth:`fit` or :meth:`load`.  The fitted arrays are treated
    as immutable; the only mutable state is the extraction cache, bounded
    by ``max_cached_hierarchies`` (LRU), and the prediction walk tables
    derived from the cached extractions.
    """

    def __init__(
        self,
        *,
        X: np.ndarray,
        msts: multi.MultiMSTResult,
        policy: SelectionPolicy,
        plan: "engine.Plan",
        config: dict,
        provenance: dict | None = None,
        max_cached_hierarchies: int | None = None,
    ):
        self.X = X
        self.msts = msts
        self.default_policy = policy
        self.plan = plan
        self.config = config
        self.provenance = provenance or {}
        self.max_cached_hierarchies = max_cached_hierarchies
        self._linkage: multi.LinkageRange | None = None
        self._cache: collections.OrderedDict[
            tuple[int, SelectionPolicy], multi.HierarchyResult
        ] = collections.OrderedDict()
        self._walk: dict[SelectionPolicy, dict[int, predict.WalkTable]] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def fit(
        cls,
        X,
        kmax: int = 16,
        *,
        kmin: int = 2,
        mpts_values: Sequence[int] | None = None,
        policy: SelectionPolicy | None = None,
        variant: str = "rng_star",
        device=None,
        mesh=None,
        plan: "engine.Plan | str" = "auto",
        max_cached_hierarchies: int | None = None,
    ) -> "FittedModel":
        """One fit buys the whole mpts range (no extraction happens here).

        ``device`` defaults to ``"cuda"`` and raises without a card; pass
        ``device="cpu"`` for the plain PyTorch versions of the kernels.
        ``mesh`` and ``plan`` place the fit (``engine.resolve_plan``): with
        a mesh, every rank of its process group calls ``fit`` on the same X.
        """
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-d (n_samples, n_features); got {X.shape}")
        if kmax < 2:
            raise ValueError(f"kmax must be >= 2; got {kmax}")
        if X.shape[0] <= kmax:
            raise ValueError(f"n_samples must exceed kmax; got n={X.shape[0]}, kmax={kmax}")
        if not (np.issubdtype(X.dtype, np.number) or X.dtype == np.bool_):
            raise ValueError(f"X must be numeric; got dtype {X.dtype}")
        bad = ~np.isfinite(X)
        if bad.any():
            rows = np.flatnonzero(bad.any(axis=1))
            raise ValueError(
                f"X contains {int(bad.sum())} non-finite value(s) "
                f"(NaN or inf) in {len(rows)} row(s), first at row "
                f"{int(rows[0])}; clean or impute before fit()"
            )
        policy = policy if policy is not None else SelectionPolicy()
        resolved = engine.resolve_plan(plan, device=device, mesh=mesh)
        msts = multi.fit_msts(
            X, kmax, kmin=kmin, variant=variant, mpts_values=mpts_values, plan=resolved,
        )
        config = {
            "n": int(X.shape[0]),
            "d": int(X.shape[1]),
            "x_dtype": str(X.dtype),
            "kmax": int(kmax),
            "kmin": int(kmin),
            "mpts_values": [int(m) for m in msts.mpts_values],
            "variant": variant,
        }
        return cls(
            X=X,
            msts=msts,
            policy=policy,
            plan=resolved,
            config=config,
            provenance=cls._fresh_provenance(resolved, X),
            max_cached_hierarchies=max_cached_hierarchies,
        )

    @staticmethod
    def _fresh_provenance(plan: "engine.Plan", X: np.ndarray) -> dict:
        from .. import __version__

        dev = torch.device(plan.device)
        return {
            "repro_version": __version__,
            "git_sha": _git_sha(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "numpy_version": np.__version__,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "backend": plan.backend,
            "plan": plan.describe(),
            "x_dtype": str(X.dtype),
        }

    # -- cheap metadata ----------------------------------------------------

    @property
    def n_samples(self) -> int:
        return self.msts.n

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    @property
    def kmax(self) -> int:
        return self.msts.kmax

    @property
    def mpts_values(self) -> list[int]:
        return list(self.msts.mpts_values)

    @property
    def config_hash(self) -> str:
        """16-hex fingerprint of the workload config (n/d/dtype/range/variant)."""
        return _config_hash(self.config)

    @property
    def graph(self):
        """The fitted RNG^kmax (RngGraph: edges, d2, variant, stats)."""
        return self.msts.graph

    @property
    def n_graph_edges(self) -> int:
        return len(self.msts.graph.edges)

    def row_of(self, mpts: int) -> int:
        """Index of ``mpts`` in the fitted range (KeyError outside it)."""
        return self.msts.row_of(mpts)

    # -- query views -------------------------------------------------------

    def _resolve_policy(self, policy: SelectionPolicy | None) -> SelectionPolicy:
        return self.default_policy if policy is None else policy

    def _ensure_linkage(self) -> multi.LinkageRange:
        """All dendrograms for the range at once, on first need, on the
        model's device."""
        if self._linkage is None:
            self._linkage = multi.linkage_range(self.msts, device=self.plan.device)
        return self._linkage

    def hierarchy(self, mpts: int, policy: SelectionPolicy | None = None) -> multi.HierarchyResult:
        """Condensed tree / stabilities / labels at one level (LRU-cached
        per (mpts, policy))."""
        row = self.msts.row_of(mpts)
        pol = self._resolve_policy(policy)
        key = (mpts, pol)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        h = multi.extract_one_from_linkage(self.msts, self._ensure_linkage(), row, policy=pol)
        self._cache[key] = h
        bound = self.max_cached_hierarchies
        while bound is not None and len(self._cache) > bound:
            (em, ep), _ = self._cache.popitem(last=False)
            self._walk.get(ep, {}).pop(em, None)
        return h

    def select(self, mpts: int, policy: SelectionPolicy | None = None) -> Clustering:
        """The clustering at one density level under one selection policy."""
        pol = self._resolve_policy(policy)
        return Clustering(mpts=mpts, policy=pol, hierarchy=self.hierarchy(mpts, pol))

    def select_all(self, policy: SelectionPolicy | None = None) -> list[Clustering]:
        """Every fitted density level, from one batched linkage pass."""
        self._ensure_linkage()
        return [self.select(m, policy) for m in self.msts.mpts_values]

    def mst(self, mpts: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ea, eb, w) MST edges under mutual reachability at this mpts."""
        row = self.msts.row_of(mpts)
        return self.msts.mst_ea[row], self.msts.mst_eb[row], self.msts.mst_w[row]

    # -- out-of-sample prediction ------------------------------------------

    def _walk_cache(self, policy: SelectionPolicy) -> dict[int, predict.WalkTable]:
        return self._walk.setdefault(policy, {})

    def predict_range(
        self,
        Q,
        *,
        mpts_values: Sequence[int] | None = None,
        policy: SelectionPolicy | None = None,
    ) -> predict.PredictResult:
        """Out-of-sample assignment for the requested mpts rows (one pass)."""
        pol = self._resolve_policy(policy)
        Q = np.asarray(Q)
        predict.validate_queries(Q, self.n_features)
        return predict.predict_range(
            self.msts,
            self.X,
            Q,
            lambda m: self.hierarchy(m, pol),
            plan=self.plan,
            mpts_values=mpts_values,
            table_cache=self._walk_cache(pol),
        )

    def approximate_predict(self, Q, mpts: int | None = None, policy: SelectionPolicy | None = None):
        """hdbscan-style ``approximate_predict`` over the fitted state.

        With ``mpts`` given: ``(labels, probabilities)`` for that level;
        with ``mpts=None``: the full per-mpts
        :class:`~repro_torch.core.predict.PredictResult`.
        """
        res = self.predict_range(Q, mpts_values=None if mpts is None else [mpts], policy=policy)
        if mpts is None:
            return res
        return res.labels[0], res.probabilities[0]

    def mpts_profile(self, policy: SelectionPolicy | None = None) -> list[dict]:
        """One summary row per density level (the paper's exploration query)."""
        rows = []
        for mpts in self.msts.mpts_values:
            h = self.hierarchy(mpts, policy)
            sizes = np.bincount(h.labels[h.labels >= 0], minlength=h.n_clusters)
            selected_stab = sorted((h.stability.get(c, 0.0) for c in h.selected), reverse=True)
            rows.append({
                "mpts": mpts,
                "n_clusters": h.n_clusters,
                "n_noise": int((h.labels == -1).sum()),
                "cluster_sizes": sizes.tolist(),
                "max_stability": float(selected_stab[0]) if selected_stab else 0.0,
                "total_stability": float(sum(selected_stab)),
            })
        return rows

    def dbcv_profile(self, policy: SelectionPolicy | None = None) -> list[dict]:
        """DBCV relative validity at every fitted density level."""
        rows = []
        for mpts in self.msts.mpts_values:
            h = self.hierarchy(mpts, policy)
            rows.append({
                "mpts": mpts,
                "dbcv": dbcv_mod.dbcv_relative_validity(h.mst_ea, h.mst_eb, h.mst_w, h.labels),
                "n_clusters": h.n_clusters,
            })
        return rows

    # -- artifact layer ----------------------------------------------------

    def save(self, path: str) -> str:
        """Write the fitted state as one ``.npz`` artifact (atomic replace),
        in the reference's format: the fitted arrays flat, plus a
        ``__header__`` entry of UTF-8 JSON (format tag, schema version,
        config + hash, default policy, provenance).  Returns ``path``."""
        arrays, msts_meta = multi.pack_msts(self.msts)
        header = {
            "format": _ARTIFACT_FORMAT,
            "schema_version": ARTIFACT_SCHEMA_VERSION,
            "config": self.config,
            "config_hash": self.config_hash,
            "policy": self.default_policy.to_dict(),
            "provenance": self.provenance,
            "msts_meta": msts_meta,
        }
        header_bytes = np.frombuffer(
            json.dumps(header, sort_keys=True).encode("utf-8"), dtype=np.uint8
        )
        dirname = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, __header__=header_bytes, X=self.X, **arrays)
            os.replace(tmp, path)  # a loader never sees a half-written file
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    @classmethod
    def load(
        cls,
        path: str,
        *,
        device=None,
        mesh=None,
        plan: "engine.Plan | str" = "auto",
        policy: SelectionPolicy | None = None,
        max_cached_hierarchies: int | None = None,
        expect_config_hash: str | None = None,
    ) -> "FittedModel":
        """Boot a FittedModel from a saved artifact (either package's).

        Placement is resolved fresh on this host with the same ``device``,
        ``mesh`` and ``plan`` policy as :meth:`fit`.  Any problem with the file is an
        :class:`ArtifactError` naming it.
        """
        try:
            with np.load(path, allow_pickle=False) as z:
                files = set(z.files)
                if "__header__" not in files:
                    raise ArtifactError(f"{path}: no __header__ entry — not a FittedModel artifact")
                try:
                    header = json.loads(z["__header__"].tobytes().decode("utf-8"))
                except (ValueError, UnicodeDecodeError) as e:
                    raise ArtifactError(f"{path}: corrupted artifact header ({e})") from e
                cls._check_header(path, header, expect_config_hash)
                if "X" not in files:
                    raise ArtifactError(f"{path}: artifact is missing arrays ['X']")
                X = z["X"]
                arrays = {k: z[k] for k in files if k not in ("__header__", "X")}
        except ArtifactError:
            raise
        except Exception as e:  # unreadable zip, truncated entries, OSError
            raise ArtifactError(
                f"{path}: not a readable FittedModel artifact ({type(e).__name__}: {e})"
            ) from e

        try:
            msts = multi.unpack_msts(arrays, header["msts_meta"])
        except KeyError as e:
            raise ArtifactError(f"{path}: artifact is missing arrays [{e}]") from e
        config = header["config"]
        cls._check_consistency(path, config, X, msts)
        pol = policy if policy is not None else SelectionPolicy.from_dict(header.get("policy", {}))
        return cls(
            X=X,
            msts=msts,
            policy=pol,
            plan=engine.resolve_plan(plan, device=device, mesh=mesh),
            config=config,
            provenance=header.get("provenance", {}),
            max_cached_hierarchies=max_cached_hierarchies,
        )

    @staticmethod
    def _check_header(path, header, expect_config_hash):
        if header.get("format") != _ARTIFACT_FORMAT:
            raise ArtifactError(
                f"{path}: header format {header.get('format')!r} is not "
                f"{_ARTIFACT_FORMAT!r} — not a FittedModel artifact"
            )
        version = header.get("schema_version")
        if version != ARTIFACT_SCHEMA_VERSION:
            raise ArtifactError(
                f"{path}: artifact schema version {version} but this build "
                f"reads version {ARTIFACT_SCHEMA_VERSION}; re-save the model "
                f"with a matching build"
            )
        config = header.get("config")
        if not isinstance(config, dict) or "config_hash" not in header:
            raise ArtifactError(f"{path}: artifact header has no config fingerprint")
        actual = _config_hash(config)
        if actual != header["config_hash"]:
            raise ArtifactError(
                f"{path}: config fingerprint mismatch (header says "
                f"{header['config_hash']}, config hashes to {actual}) — the "
                f"artifact was corrupted or hand-edited; refit and re-save"
            )
        if expect_config_hash is not None and actual != expect_config_hash:
            raise ArtifactError(
                f"{path}: artifact config hash {actual} does not match the "
                f"expected {expect_config_hash} (different dataset, kmax, "
                f"range, or variant than this deployment was built for)"
            )

    @staticmethod
    def _check_consistency(path, config, X, msts):
        problems = []
        if tuple(X.shape) != (config.get("n"), config.get("d")):
            problems.append(
                f"X shape {tuple(X.shape)} != config (n, d)=({config.get('n')}, {config.get('d')})"
            )
        if msts.kmax != config.get("kmax"):
            problems.append(f"msts kmax {msts.kmax} != config kmax {config.get('kmax')}")
        if msts.cd2.shape != (msts.n, msts.kmax):
            problems.append(f"cd2 shape {msts.cd2.shape} != (n, kmax)=({msts.n}, {msts.kmax})")
        if list(msts.mpts_values) != list(config.get("mpts_values", [])):
            problems.append("stored mpts rows disagree with the config range")
        if msts.mst_ea.shape != (len(msts.mpts_values), msts.n - 1):
            problems.append(
                f"MST row array shape {msts.mst_ea.shape} != "
                f"(R, n-1)=({len(msts.mpts_values)}, {msts.n - 1})"
            )
        if problems:
            raise ArtifactError(
                f"{path}: artifact arrays disagree with its config "
                f"fingerprint ({'; '.join(problems)}) — corrupted or "
                f"mixed-up artifact; refit and re-save"
            )

    def __repr__(self) -> str:
        return (
            f"FittedModel(n={self.n_samples}, d={self.n_features}, "
            f"kmax={self.kmax}, R={len(self.msts.mpts_values)}, "
            f"policy={self.default_policy.describe()!r}, "
            f"config_hash={self.config_hash}, plan={self.plan.describe()})"
        )
