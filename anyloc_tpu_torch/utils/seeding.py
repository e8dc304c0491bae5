"""Determinism utilities (counterpart of ``anyloc_tpu/utils/seeding.py``;
the reference's ``utilities.py:505-519,1011`` and dvgl
``commons.py:14-27`` ``make_deterministic``).

The global RNGs seeded are python's, numpy's and torch's (CPU and every
card); randomness of the port's own code comes from explicit
``torch.Generator``s, which ``key_stream`` derives from one root seed in
place of the JAX package's ``jax.random`` keys.
"""

from __future__ import annotations

import os
import random
from typing import Iterator

import numpy as np
import torch


def seed_everything(seed: int = 42) -> None:
    """Seed python / numpy / torch's global RNGs and ``PYTHONHASHSEED``."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def make_deterministic(seed: int = 42) -> None:
    """dvgl commons.py's name for ``seed_everything``."""
    seed_everything(seed)


def key_stream(seed: int = 42) -> Iterator[torch.Generator]:
    """An endless stream of fresh ``torch.Generator``s, each seeded from a
    root generator seeded with ``seed``."""
    root = torch.Generator().manual_seed(seed)
    while True:
        yield torch.Generator().manual_seed(int(torch.randint(0, 2 ** 62, (), generator=root)))
