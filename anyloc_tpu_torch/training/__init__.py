"""The trained baselines' evaluation path (counterpart of
``anyloc_tpu/training/``): the learned aggregators, GeoLocalizationNet,
the MixVPR / CosPlace models and their release converters, ``evaluate``
and the ``eval`` CLI.

Training itself (triplet losses and steps, mining, CosPlace's classes and
CosFace step, the train loop and CLI) is not ported: its names raise,
naming the ROADMAP.md port-queue item "Training".
"""

from anyloc_tpu_torch.training.aggregators import GeMHead, MixVPRHead, NetVLAD

# the JAX package's training names, by the module that defines them
_NOT_PORTED = {
    "TripletTrainState": "triplet", "make_triplet_train_step": "triplet",
    "triplet_margin_loss": "triplet", "sare_ind_loss": "triplet", "sare_joint_loss": "triplet",
    "TripletMiner": "mining", "train_triplet": "train_loop", "train_cli": "train_cli",
    "assign_classes": "cosplace", "MarginCosineProduct": "cosplace",
    "cosface_loss_fn": "cosplace", "CosPlaceTrainState": "cosplace",
    "make_cosplace_train_step": "cosplace",
}

__all__ = ["NetVLAD", "GeMHead", "MixVPRHead"]


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} (training/{_NOT_PORTED[name]}.py) is not ported yet (ROADMAP.md, port "
            'queue: "Training")')
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
