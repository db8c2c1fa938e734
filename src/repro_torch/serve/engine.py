"""Clustering serve engine: fit once (or load an artifact), answer traffic.
The port of ``repro/serve/engine.py``, over the port's
:class:`~repro_torch.api.FittedModel`.

A process-resident engine over ONE fitted model whose multi-MST state
answers three request families:

  * ``predict``  — out-of-sample assignment of query points (any subset of
    the fitted mpts range, or all of it),
  * ``labels`` / ``membership`` — the fitted labelling at one density level,
    with an optional per-request :class:`~repro_torch.api.SelectionPolicy`
    (cheap per-query re-selection over the same cached linkage),
  * ``profile`` / ``dbcv_profile`` — whole-range summaries.

Scale-out is refit-free: ``ClusterServeEngine.load(path)`` boots a worker
from a saved artifact (either package's): the fit happens once, anywhere.

Requests enter a queue from any number of client threads; ONE worker thread
owns the model (no lock on the fitted state) and **micro-batches**
concurrent predict requests: after the first request lands it waits up to
``max_delay_ms`` for company, then concatenates up to ``max_batch`` query
rows into a single device pass — one ``query_knn`` + attach serves every
rider, whatever mix of mpts values they asked for (riders with different
selection *policies* share the pass group by group: the attach is
policy-independent, only the host tree walk differs).  Per-(mpts, policy)
extractions are LRU-bounded (``hierarchy_cache_size``).

The worker runs every device pass on the model's own device: a CUDA
model's device index is fixed when the engine is built and made the
worker thread's current device, since each thread starts on device 0.  A
failing pass fails every rider of its batch; nothing falls back to the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from ..api.model import FittedModel
from ..api.selection import SelectionPolicy
from ..core import predict


@dataclasses.dataclass
class _Pending:
    kind: str                   # "predict" | "labels" | "membership" | "profile" | "dbcv"
    future: Future
    t_submit: float
    q: np.ndarray | None = None
    mpts: int | None = None
    policy: SelectionPolicy | None = None   # per-request selection override


def _model_device(model: FittedModel) -> torch.device:
    """The model's device with its index made explicit: ``"cuda"`` alone
    means the building thread's current device."""
    dev = torch.device(model.plan.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ClusterServeEngine:
    """Process-resident serving over one fitted model.

    Parameters
    ----------
    model : repro_torch.api.FittedModel or a *fitted* repro_torch.api.MultiHDBSCAN
        The fitted state to serve.  The engine takes ownership: it installs
        its LRU bound on the model's extraction cache and serializes all
        access through its worker.  Passing an estimator serves its
        ``model_``.
    max_batch : int
        Max query rows fused into one predict device pass.
    max_delay_ms : float
        How long the worker holds the first predict request of a batch
        waiting for riders.  The knob trades p50 latency for throughput.
    hierarchy_cache_size : int
        LRU bound on cached per-(mpts, policy) extractions (and their walk
        tables).
    """

    def __init__(
        self,
        model,
        *,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        hierarchy_cache_size: int = 8,
    ):
        if isinstance(model, FittedModel):
            self.model = model
            self.estimator = None
        else:  # a fitted MultiHDBSCAN estimator
            if getattr(model, "_model", None) is None:
                raise RuntimeError(
                    "ClusterServeEngine needs a FittedModel or a fitted "
                    "estimator; call fit(X) first (or use "
                    "ClusterServeEngine.fit / ClusterServeEngine.load)"
                )
            self.model = model.model_
            self.estimator = model
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        if hierarchy_cache_size < 1:
            raise ValueError(
                f"hierarchy_cache_size must be >= 1; got {hierarchy_cache_size}"
            )
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.model.max_cached_hierarchies = hierarchy_cache_size
        if self.estimator is not None:
            self.estimator.max_cached_hierarchies = hierarchy_cache_size
        self.device = _model_device(self.model)

        self._queue: collections.deque[_Pending] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._latencies: collections.deque[float] = collections.deque(maxlen=8192)
        self._n_requests = 0
        self._n_queries = 0
        self._n_batches = 0
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._worker = threading.Thread(
            target=self._run, name="cluster-serve-worker", daemon=True
        )
        self._worker.start()

    @classmethod
    def fit(cls, X, *, serve_options: dict | None = None, **estimator_options):
        """Fit a fresh estimator and wrap it (the one-call serving path).
        ``estimator_options`` go to ``MultiHDBSCAN`` (``device`` defaults
        to ``"cuda"``)."""
        from ..api import MultiHDBSCAN

        est = MultiHDBSCAN(**estimator_options).fit(X)
        return cls(est, **(serve_options or {}))

    @classmethod
    def load(
        cls,
        path: str,
        *,
        device=None,
        serve_options: dict | None = None,
        **load_options,
    ) -> "ClusterServeEngine":
        """Boot a serve worker from a saved FittedModel artifact — no refit.

        ``device`` (default ``"cuda"``, which raises without a card unless
        ``device="cpu"`` is asked for) and ``load_options`` (``mesh``,
        ``plan``, ``policy``, ``expect_config_hash``) forward to
        :meth:`FittedModel.load`; ``serve_options`` to the engine
        constructor (``max_batch``, ``max_delay_ms``,
        ``hierarchy_cache_size``).
        """
        model = FittedModel.load(path, device=device, **load_options)
        return cls(model, **(serve_options or {}))

    # -- client surface (thread-safe) --------------------------------------

    def submit_predict(
        self,
        Q,
        mpts: int | None = None,
        policy: SelectionPolicy | None = None,
    ) -> Future:
        """Enqueue an out-of-sample batch; resolves to (labels, probs) for
        one mpts, or a PredictResult for the whole range (mpts=None).

        Malformed requests (wrong feature count, NaN coordinates, mpts
        outside the fitted range) are rejected HERE, before enqueueing — a
        bad request must fail alone, never poison the strangers it would
        have been micro-batched with.
        """
        # lint: allow[lock-discipline] benign racy fast-fail; _submit rechecks under the lock
        if self._closed:
            raise RuntimeError("ClusterServeEngine is closed")
        Q = np.asarray(Q)
        if Q.ndim == 1:
            Q = Q[None, :]
        predict.validate_queries(Q, self.model.n_features)
        if mpts is not None:
            self.model.row_of(mpts)  # KeyError early
        return self._submit(
            _Pending("predict", Future(), time.monotonic(), q=Q, mpts=mpts, policy=policy)
        )

    def predict(
        self,
        Q,
        mpts: int | None = None,
        policy: SelectionPolicy | None = None,
        timeout: float | None = 60.0,
    ):
        """Blocking ``submit_predict`` (still rides shared micro-batches)."""
        return self.submit_predict(Q, mpts, policy).result(timeout=timeout)

    def labels(
        self,
        mpts: int,
        *,
        policy: SelectionPolicy | None = None,
        cluster_selection_method: str | None = None,
        allow_single_cluster: bool | None = None,
        timeout: float | None = 60.0,
    ) -> np.ndarray:
        """Fitted labels at one level; selection is per-request.

        Pass a :class:`SelectionPolicy` for the full surface (method,
        epsilon, min_cluster_size); the two keyword knobs are sugar over
        ``model.default_policy.replace(...)``.
        """
        policy = self._legacy_policy(policy, cluster_selection_method, allow_single_cluster)
        p = _Pending("labels", Future(), time.monotonic(), mpts=mpts, policy=policy)
        return self._submit(p).result(timeout=timeout)

    def membership(
        self,
        mpts: int,
        policy: SelectionPolicy | None = None,
        timeout: float | None = 60.0,
    ):
        """The full Clustering view at one level: labels + probabilities +
        lambdas + exemplars."""
        p = _Pending("membership", Future(), time.monotonic(), mpts=mpts, policy=policy)
        return self._submit(p).result(timeout=timeout)

    def profile(self, timeout: float | None = 60.0) -> list[dict]:
        return self._submit(_Pending("profile", Future(), time.monotonic())).result(timeout=timeout)

    def dbcv_profile(self, timeout: float | None = 60.0) -> list[dict]:
        return self._submit(_Pending("dbcv", Future(), time.monotonic())).result(timeout=timeout)

    def _legacy_policy(
        self,
        policy: SelectionPolicy | None,
        cluster_selection_method: str | None,
        allow_single_cluster: bool | None,
    ) -> SelectionPolicy | None:
        if cluster_selection_method is None and allow_single_cluster is None:
            return policy
        if policy is not None:
            raise ValueError(
                "pass either policy= or the legacy cluster_selection_method/"
                "allow_single_cluster knobs, not both"
            )
        base = self.model.default_policy
        changes: dict = {}
        if cluster_selection_method is not None:
            changes["method"] = cluster_selection_method
        if allow_single_cluster is not None:
            changes["allow_single_cluster"] = allow_single_cluster
        return base.replace(**changes)

    def stats(self) -> dict:
        """Latency/throughput counters over the engine's lifetime so far."""
        with self._cv:
            lat = sorted(self._latencies)
            n_req, n_q, n_b = self._n_requests, self._n_queries, self._n_batches
            t0, t1 = self._t_first, self._t_last
        pct = lambda p: float(lat[min(len(lat) - 1, int(p * len(lat)))]) if lat else 0.0  # noqa: E731
        wall = (t1 - t0) if (t0 is not None and t1 is not None and t1 > t0) else 0.0
        return {
            "n_requests": n_req,
            "n_queries": n_q,
            "n_batches": n_b,
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p95_ms": round(pct(0.95) * 1e3, 3),
            "queries_per_s": round(n_q / wall, 1) if wall > 0 else 0.0,
            "mean_batch": round(n_q / max(n_b, 1), 2),
        }

    def reset_stats(self) -> None:
        """Zero the latency/throughput counters (e.g. after warmup)."""
        with self._cv:
            self._latencies.clear()
            self._n_requests = self._n_queries = self._n_batches = 0
            self._t_first = self._t_last = None

    def close(self) -> None:
        """Drain nothing, reject everything pending, stop the worker."""
        # lint: allow[lock-discipline] benign racy idempotence check; stale False just retakes the lock
        if self._closed:
            return
        with self._cv:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        for p in pending:
            p.future.set_exception(RuntimeError("ClusterServeEngine closed"))
        self._worker.join(timeout=10.0)

    def __enter__(self) -> "ClusterServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ------------------------------------------------------------

    def _submit(self, p: _Pending):
        with self._cv:
            if self._closed:
                raise RuntimeError("ClusterServeEngine is closed")
            self._queue.append(p)
            self._cv.notify_all()
        return p.future

    def _take_batch(self) -> list[_Pending]:
        """Pop the next unit of work: one non-predict request, or a micro-
        batch of predict requests (first-come, held ``max_delay_ms`` for
        riders, capped at ``max_batch`` total query rows)."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait(timeout=0.1)
            if self._closed:
                return []
            head = self._queue.popleft()
            if head.kind != "predict":
                return [head]
            batch = [head]
            rows = len(head.q)
            deadline = time.monotonic() + self.max_delay_ms / 1e3
            while rows < self.max_batch:
                if not self._queue:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    self._cv.wait(timeout=remain)
                    if self._closed:
                        break
                    continue
                if self._queue[0].kind != "predict":
                    break  # preserve FIFO fairness for non-predict work
                nxt = self._queue[0]
                if rows + len(nxt.q) > self.max_batch and rows > 0:
                    break
                self._queue.popleft()
                batch.append(nxt)
                rows += len(nxt.q)
            return batch

    def _run(self) -> None:
        # the worker thread's current CUDA device is 0 until set: make it
        # the model's, so every "cuda" tensor of a pass lands there
        on_card = self.device.type == "cuda"
        with torch.cuda.device(self.device) if on_card else contextlib.nullcontext():
            while True:
                batch = self._take_batch()
                if not batch:
                    return
                try:
                    if batch[0].kind == "predict":
                        self._serve_predict(batch)
                    else:
                        self._serve_one(batch[0])
                except Exception as e:  # noqa: BLE001 - failures belong to callers
                    for p in batch:
                        if not p.future.done():
                            p.future.set_exception(e)

    def _serve_predict(self, batch: list[_Pending]) -> None:
        """One fused device pass per *policy group* of the micro-batch.

        The attach stage is policy-independent, but the host tree walk is
        not, so riders are grouped by their (resolved) selection policy —
        the common single-policy batch stays one pass.
        """
        model = self.model
        groups: dict[SelectionPolicy, list[_Pending]] = {}
        for p in batch:
            pol = p.policy if p.policy is not None else model.default_policy
            groups.setdefault(pol, []).append(p)
        for pol, group in groups.items():
            # one device pass for every rider: union of requested levels
            # (any full-range request widens it to the whole fitted range)
            if any(p.mpts is None for p in group):
                mpts_values: Sequence[int] = list(model.msts.mpts_values)
            else:
                mpts_values = sorted({p.mpts for p in group})
            Q = np.concatenate([p.q for p in group], axis=0)
            res = model.predict_range(Q, mpts_values=list(mpts_values), policy=pol)
            t_done = time.monotonic()
            start = 0
            for p in group:
                stop = start + len(p.q)
                if p.mpts is None:
                    out = predict.PredictResult(
                        mpts_values=list(res.mpts_values),
                        labels=res.labels[:, start:stop],
                        probabilities=res.probabilities[:, start:stop],
                        lambdas=res.lambdas[:, start:stop],
                        neighbors=res.neighbors[:, start:stop],
                    )
                else:
                    r = res.mpts_values.index(p.mpts)
                    out = (res.labels[r, start:stop], res.probabilities[r, start:stop])
                p.future.set_result(out)
                start = stop
            # account per group, each with its OWN completion time: a rider's
            # recorded latency must not include other groups' device passes,
            # and a later group's failure must not erase served riders
            self._account(group, t_done, n_queries=len(Q), n_batches=1)

    def _serve_one(self, p: _Pending) -> None:
        model = self.model
        if p.kind == "labels":
            out = model.select(p.mpts, p.policy).labels
        elif p.kind == "membership":
            out = model.select(p.mpts, p.policy)
        elif p.kind == "profile":
            out = model.mpts_profile()
        elif p.kind == "dbcv":
            out = model.dbcv_profile()
        else:  # pragma: no cover - _Pending kinds are internal
            raise ValueError(f"unknown request kind {p.kind!r}")
        p.future.set_result(out)
        self._account([p], time.monotonic(), n_queries=0, n_batches=0)

    def _account(
        self, batch: list[_Pending], t_done: float, *, n_queries: int, n_batches: int
    ) -> None:
        with self._cv:
            for p in batch:
                self._latencies.append(t_done - p.t_submit)
            self._n_requests += len(batch)
            self._n_queries += n_queries
            self._n_batches += n_batches
            if self._t_first is None:
                self._t_first = batch[0].t_submit
            self._t_last = t_done
