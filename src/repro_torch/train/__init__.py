"""Training layer of the port, as in ``repro.train``: so far the data
pipeline (``data``), which the embedding path reads.  The train step, the
optimizer, checkpoints and metrics come with a later item of
``ROADMAP.md`` §1."""

from . import data

__all__ = ["data"]
