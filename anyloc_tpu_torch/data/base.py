"""VPRDataset — the dataset protocol shared by every loader.

A copy of ``anyloc_tpu/data/base.py`` without the native C++ decode (the
port cannot import that package without importing JAX; the native decode
is a later item of the port). Items are ordered [database..., queries...];
``batches()`` yields static-shape channels-last batches with background
prefetch, padding the last batch by repeating its final item (index -1).
"""

from __future__ import annotations

import os
import queue as _queue
import re
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from anyloc_tpu_torch.data.transforms import load_image, load_image_u8


def _nat_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def natsorted(items: Sequence[str]) -> List[str]:
    """Natural sort (file2 < file10)."""
    return sorted(items, key=_nat_key)


def listdir_abs(root: str, sub: str) -> List[str]:
    """Natural-sorted absolute paths of a dataset subdirectory."""
    d = os.path.join(root, sub)
    return [os.path.join(d, p) for p in natsorted(os.listdir(d))]


class VPRDataset:
    """Base class over ``db_paths`` + ``query_paths`` absolute path lists."""

    def __init__(
        self,
        db_paths: Sequence[str],
        query_paths: Sequence[str],
        soft_positives_per_query=None,
        img_size: Optional[Tuple[int, int]] = (320, 320),
    ) -> None:
        self.db_paths = list(db_paths)
        self.query_paths = list(query_paths)
        self.images_paths = self.db_paths + self.query_paths
        self.database_num = len(self.db_paths)
        self.queries_num = len(self.query_paths)
        self.soft_positives_per_query = soft_positives_per_query
        self.img_size = img_size

    def get_image_paths(self) -> List[str]:
        return self.images_paths

    def get_positives(self):
        return self.soft_positives_per_query

    def __len__(self) -> int:
        return len(self.images_paths)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int]:
        return load_image(self.images_paths[index], self.img_size), index

    def indices(self, which: str = "all", sub_sample: int = 1) -> np.ndarray:
        if which == "db":
            idx = np.arange(0, self.database_num)
        elif which == "queries":
            idx = np.arange(self.database_num, len(self))
        else:
            idx = np.arange(len(self))
        return idx[::sub_sample]

    def batches(
        self,
        batch_size: int,
        which: str = "all",
        sub_sample: int = 1,
        output: str = "float32",
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (images [B, H, W, 3], indices [B]) with background prefetch.
        The final short batch is padded by repeating its last item; padded
        entries carry index -1.

        ``output``: "float32" = normalized f32; "uint8" = resized raw uint8,
        normalized on the device by the extractor."""
        if output not in ("float32", "uint8"):
            raise ValueError(f"output must be 'float32' or 'uint8', got {output!r}")
        if output == "uint8":
            if type(self).__getitem__ is not VPRDataset.__getitem__:
                raise ValueError(
                    "output='uint8' requires the standard loader; "
                    f"{type(self).__name__} overrides __getitem__ — use the "
                    "float32 output for custom item transforms"
                )
            if self.img_size is None:
                raise ValueError("output='uint8' requires a fixed img_size")
        idx = self.indices(which, sub_sample)

        def load_batch(batch_idx):
            if output == "uint8":
                return np.stack([
                    load_image_u8(self.images_paths[int(i)], self.img_size)
                    for i in batch_idx
                ])
            return np.stack([self[int(i)][0] for i in batch_idx])

        def gen():
            for s in range(0, len(idx), batch_size):
                chunk = idx[s : s + batch_size]
                out_idx = np.full(batch_size, -1, np.int64)
                out_idx[: len(chunk)] = chunk
                if len(chunk) < batch_size:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], batch_size - len(chunk))]
                    )
                yield load_batch(chunk), out_idx

        return _prefetched(gen())


def _prefetched(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a daemon thread with a bounded queue — overlaps
    host image decode with device compute."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def radius_positives(
    db_xy: np.ndarray, qu_xy: np.ndarray, radius: float
) -> List[np.ndarray]:
    """Soft positives by metric radius (exact brute force)."""
    d2 = ((qu_xy[:, None, :] - db_xy[None, :, :]) ** 2).sum(-1)
    r2 = radius * radius
    return [np.where(row <= r2)[0] for row in d2]
