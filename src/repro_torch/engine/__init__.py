"""Execution-plan layer: one resolved `Plan` threaded through every stage.

``Plan`` freezes the execution decisions (device, kernel backend and every
chunk and tile size) once, at the front door, so the pipeline stages never
re-derive where they run.  ``io`` holds the device->host choke point: every
bulk materialization in the pipeline goes through ``to_host``, which a test
ledger records.
"""

from . import io, plan
from .io import to_host, transfer_ledger
from .plan import Plan, resolve_plan

__all__ = ["Plan", "io", "plan", "resolve_plan", "to_host", "transfer_ledger"]
