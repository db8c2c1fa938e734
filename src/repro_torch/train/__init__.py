"""Training layer of the port, as in ``repro.train``: the data pipeline
(``data``), the optimizers (``optim``), the train step (``step``),
checkpoints (``checkpoint``) and metrics (``metrics``)."""

from . import checkpoint, data, metrics, optim, step

__all__ = ["checkpoint", "data", "metrics", "optim", "step"]
