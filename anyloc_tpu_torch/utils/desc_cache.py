"""Sharded patch-descriptor cache — the framework's "computation cache as
resumable state" (SURVEY.md §5 checkpoint row: the reference caches VLAD
residuals/labels per image as .pt files keyed by relpath; here whole
descriptor arrays store as npz shards keyed by the extraction config, so an
interrupted database extraction resumes at shard granularity).

Robustness contract (round-5 review): shard writes are ATOMIC (tmp +
os.replace — a killed extraction or a concurrent writer can never leave a
torn .npz that poisons every resume), unreadable shards count as a MISS
(recompute, never crash), a shorter rewrite removes its predecessors'
stale higher shards, the shard layout (shard_size) is part of the cache
identity, and coverage checks are explicit raises — never bare asserts
that ``python -O`` would strip into silently-truncated descriptor arrays.

A copy of ``anyloc_tpu/utils/desc_cache.py`` with the same config hash and
``.npz`` layout, so that either package reads a cache the other wrote.
Stale shards are found by listing the directory and removed without a
check-then-act race: a shard another writer removed first is no error.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np


class DescriptorCache:
    def __init__(self, cache_dir: str, config: dict, shard_size: int = 512):
        """``config`` identifies the extraction (model/layer/facet/resize
        ...); its hash — which includes ``shard_size``, since the on-disk
        layout is part of the identity — names the cache subdirectory."""
        config = dict(config, _shard_size=shard_size)
        key = hashlib.sha1(
            json.dumps(config, sort_keys=True).encode()
        ).hexdigest()[:12]
        self.dir = os.path.join(os.path.abspath(cache_dir), f"descs_{key}")
        os.makedirs(self.dir, exist_ok=True)
        meta = os.path.join(self.dir, "config.json")
        if not os.path.exists(meta):
            with open(meta, "w") as f:
                json.dump(config, f, indent=2, sort_keys=True)
        self.shard_size = shard_size

    def _shard_path(self, which: str, shard: int) -> str:
        return os.path.join(self.dir, f"{which}_{shard:05d}.npz")

    def _shard_len(self, which: str, shard: int) -> Optional[int]:
        """Row count of one shard, or None when it is missing/torn (a
        torn file is a MISS, not a crash — the module's whole point is
        surviving interrupted extractions). Reads only the .npy header
        inside the zip, not the (potentially GB-scale) array."""
        import zipfile

        path = self._shard_path(which, shard)
        try:
            with zipfile.ZipFile(path) as z:
                with z.open("descs.npy") as f:
                    version = np.lib.format.read_magic(f)
                    reader = (np.lib.format.read_array_header_1_0
                              if version == (1, 0)
                              else np.lib.format.read_array_header_2_0)
                    shape, _, _ = reader(f)
            return shape[0]
        except Exception:
            return None

    def has(self, which: str, n_items: int) -> bool:
        if n_items <= 0:
            return False
        n_shards = -(-n_items // self.shard_size)
        # every non-final shard must be full AND readable; the final shard
        # must cover the tail (a grown dataset, an interrupted write, or a
        # torn file all trigger recompute, never a read crash)
        total = 0
        for s in range(n_shards):
            ln = self._shard_len(which, s)
            if ln is None:
                return False
            if s < n_shards - 1 and ln < self.shard_size:
                return False
            total += ln
        return total >= n_items

    def write(self, which: str, descs: np.ndarray) -> None:
        n_shards = -(-len(descs) // self.shard_size) if len(descs) else 0
        for s in range(0, len(descs), self.shard_size):
            # atomic publish: a crash mid-save leaves only a tmp file the
            # next run ignores, never a torn shard at the final path
            final = self._shard_path(which, s // self.shard_size)
            tmp = final + f".tmp.{os.getpid()}"
            np.savez(
                tmp, descs=descs[s : s + self.shard_size].astype(np.float32)
            )
            # np.savez appends .npz when the target lacks it
            os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", final)
        # a shorter rewrite must not leave a previous run's higher shards
        # behind (has() would over-count and read() would crash/mismatch)
        prefix = f"{which}_"
        for name in os.listdir(self.dir):
            shard = name[len(prefix):-len(".npz")]
            if (name.startswith(prefix) and name.endswith(".npz")
                    and shard.isdigit() and int(shard) >= n_shards):
                try:
                    os.remove(os.path.join(self.dir, name))
                except FileNotFoundError:
                    pass  # another writer removed it first

    def read(self, which: str, n_items: int) -> np.ndarray:
        n_shards = -(-n_items // self.shard_size)
        parts = [
            np.load(self._shard_path(which, s))["descs"]
            for s in range(n_shards)
        ]
        out = np.concatenate(parts) if parts else np.zeros((0,), np.float32)
        if len(out) < n_items:  # explicit: must survive python -O
            raise ValueError(
                f"descriptor cache shards for {which!r} cover {len(out)} "
                f"items but {n_items} were requested — stale/corrupt cache "
                f"at {self.dir}")
        return out[:n_items]

    def get_or_compute(self, which: str, n_items: int, compute) -> np.ndarray:
        if self.has(which, n_items):
            return self.read(which, n_items)
        descs = compute()
        if len(descs) < n_items:
            raise ValueError(
                f"compute() returned {len(descs)} items but {n_items} were "
                f"promised for cache key {which!r} — refusing to cache a "
                "short result")
        self.write(which, descs)
        return descs
