"""The trained baselines (counterpart of ``anyloc_tpu/training/``): the
learned aggregators, GeoLocalizationNet, the MixVPR / CosPlace models and
their release converters, ``evaluate`` and the ``eval`` CLI; and training:
the triplet losses and step, mining, the train loop and ``train`` CLI,
CosPlace's classes and CosFace step (``training.cosplace``).
"""

from anyloc_tpu_torch.training.aggregators import GeMHead, MixVPRHead, NetVLAD
from anyloc_tpu_torch.training.triplet import (TripletTrainState, make_triplet_train_step,
                                               triplet_margin_loss)

__all__ = [
    "NetVLAD",
    "GeMHead",
    "MixVPRHead",
    "TripletTrainState",
    "make_triplet_train_step",
    "triplet_margin_loss",
]
