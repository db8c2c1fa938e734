"""Metrics logging + straggler detection hooks.

A copy of ``repro/train/metrics.py`` (pure Python).

``StepTimer`` keeps an EMA of step wall-time and flags outliers (straggler
mitigation at the host level: in a multi-host deployment the flagged host
reports itself to the coordinator, which can evict/replace it — here the
detection logic and the log trail are what we can realize and test).
"""

from __future__ import annotations

import json
import time


class JsonlLogger:
    def __init__(self, path: str | None):
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, step: int, **kv):
        rec = {"step": step, "t": time.time(), **{k: _tofloat(v) for k, v in kv.items()}}
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        return line

    def close(self):
        if self._f:
            self._f.close()


def _tofloat(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class StepTimer:
    """EMA step timer with straggler flagging (z-like threshold on EMA)."""

    def __init__(self, alpha: float = 0.1, slow_factor: float = 2.5):
        self.alpha = alpha
        self.slow_factor = slow_factor
        self.ema = None
        self.last = None
        self.stragglers = 0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.observe(time.monotonic() - self._t0)

    def observe(self, dt: float):
        self.last = dt
        self._flagged = False
        if self.ema is None:
            self.ema = dt
        else:
            if dt > self.slow_factor * self.ema:
                self.stragglers += 1
                self._flagged = True
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt

    @property
    def is_straggler(self) -> bool:
        """Was the most recent step flagged (vs the EMA at observe time)?"""
        return getattr(self, "_flagged", False)
