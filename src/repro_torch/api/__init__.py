"""Public API of the port, as in ``repro.api``:

    from repro_torch.api import FittedModel, MultiHDBSCAN, SelectionPolicy

    est = MultiHDBSCAN(kmax=16).fit(x)               # on the card
    est = MultiHDBSCAN(kmax=16, device="cpu").fit(x)  # plain PyTorch on the CPU
    est.model_.select(8).labels
    labels, probs = est.approximate_predict(q, mpts=8)  # unseen points, no refit
    est.model_.save("fitted.npz")                     # loads in either package
"""

from .estimator import Membership, MultiHDBSCAN
from .model import ArtifactError, Clustering, FittedModel
from .selection import SelectionPolicy

__all__ = ["ArtifactError", "Clustering", "FittedModel", "Membership", "MultiHDBSCAN", "SelectionPolicy"]
