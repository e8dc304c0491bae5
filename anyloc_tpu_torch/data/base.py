"""VPRDataset — the dataset protocol shared by every loader.

A copy of ``anyloc_tpu/data/base.py`` (the port cannot import that package
without importing JAX). Items are ordered [database..., queries...];
``get_image_relpaths`` gives cache IDs at ``_imgs_level`` path depth;
``batches()`` yields static-shape channels-last batches with background
prefetch, padding the last batch by repeating its final item (index -1),
decoded by the native pipe (``anyloc_tpu_torch/native.py`` over
``native/imagepipe.cpp``, on a thread pool) where it builds, else by PIL.
"""

from __future__ import annotations

import os
import queue as _queue
import re
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from anyloc_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, load_image, load_image_u8


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

    _imgs_level = 2
    # Batches decode through the native pipe (within 2e-5 of
    # transforms.load_image in f32, one step in uint8) when it builds and
    # the items are the standard decode; False forces the PIL path.
    use_native_loader = True

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

    def get_image_relpaths(self, i: Union[int, List[int]]):
        indices = [i] if isinstance(i, (int, np.integer)) else i
        s = self._imgs_level
        rel = ["/".join(self.images_paths[k].split("/")[-s:]) for k in indices]
        return rel[0] if isinstance(i, (int, np.integer)) else rel

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

    def _standard_items(self) -> bool:
        """Whether every item is ``load_image`` of its path: only then may
        batches come from the native pipe or as raw uint8."""
        return type(self).__getitem__ is VPRDataset.__getitem__

    def decoder(self) -> str:
        """The decoder ``batches()`` runs: "native" (the C++ pipe on a
        thread pool) or "PIL" (per image, on the prefetch thread)."""
        if self.use_native_loader and self.img_size is not None and self._standard_items():
            from anyloc_tpu_torch import native

            if native.imagepipe_available():
                return "native"
        return "PIL"

    def batches(
        self,
        batch_size: int,
        which: str = "all",
        sub_sample: int = 1,
        prefetch: int = 2,
        drop_remainder: bool = False,
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
            if not self._standard_items():
                raise ValueError(
                    "output='uint8' requires the standard loader; "
                    f"{type(self).__name__} transforms its items — use the "
                    "float32 output for custom item transforms"
                )
            if self.img_size is None:
                raise ValueError("output='uint8' requires a fixed img_size")
        idx = self.indices(which, sub_sample)
        if drop_remainder:
            idx = idx[: len(idx) - len(idx) % batch_size]
        native_ok = self.decoder() == "native"

        def load_one(i):
            if output == "uint8":
                return load_image_u8(self.images_paths[i], self.img_size)
            return self[i][0]

        def load_batch(batch_idx):
            if not native_ok:
                return np.stack([load_one(int(i)) for i in batch_idx])
            from anyloc_tpu_torch import native

            paths = [self.images_paths[i] for i in batch_idx]
            if output == "uint8":
                imgs, ok = native.decode_batch_u8(paths, tuple(self.img_size))
            else:
                imgs, ok = native.decode_batch(paths, tuple(self.img_size),
                                               IMAGENET_MEAN, IMAGENET_STD)
            # formats the native pipe does not know (bmp, webp, ...) go
            # through PIL, which raises its own error for broken files
            for pos in np.flatnonzero(~ok):
                imgs[pos] = load_one(int(batch_idx[pos]))
            return imgs

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

        return _prefetched(gen(), prefetch)


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Run an iterator in a daemon thread with a bounded queue — overlaps
    host image decode with device compute; depth 0 runs it inline."""
    if depth <= 0:
        yield from it
        return
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
