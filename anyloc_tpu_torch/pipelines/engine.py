"""DescriptorEngine — batched patch-descriptor extraction over a dataset
(counterpart of ``anyloc_tpu/pipelines/engine.py``).

Static-shape batches from ``dataset.batches()`` (host prefetch thread),
center-crop to a patch multiple once per batch, one truncated trunk
forward per batch, and a depth-1 pipeline: batch i+1 is dispatched to the
device before batch i's result is copied back, so the card is never idle
on the copy. With ``cache_dir`` the results that come home are kept in a
sharded ``DescriptorCache`` keyed by the extraction config and the
dataset's identity (the JAX package's keys and layout).

With ``mesh`` (``parallel/mesh.py``) every rank of the mesh runs the
engine on the same dataset: each batch's images shard over the ``data``
axis, each rank runs its block (and, with an aggregation, aggregates it),
and the outputs are all-gathered (``sharded_extract_fn``), so every rank
gets the whole result. Rank 0 alone writes the descriptor cache; the
others wait for it and read what it wrote.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.data.transforms import center_crop_multiple


class DescriptorEngine:
    def __init__(
        self,
        model_type: str = "dinov2_vits14",
        desc_layer: int = 11,
        desc_facet: str = "value",
        checkpoint: Optional[str] = None,
        dtype: str = "bfloat16",
        batch_size: int = 32,
        use_cls: bool = False,
        norm_descs: bool = True,
        mesh=None,
        extractor=None,
        cache_dir: Optional[str] = None,
        transfer_dtype: str = "float32",
        quant: Optional[str] = None,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        """``transfer_dtype``: "float32" ships normalized f32 images to the
        device; "uint8" ships raw resized bytes (1/4 the host-to-device
        traffic) and normalizes on the device. ``quant`` selects an int8
        trunk ("int8_full" is the serving mode). ``device`` None means the
        card. ``extractor`` replaces the model built from ``model_type``
        (its own device is then used). ``cache_dir`` keeps what
        ``extract_dataset`` and ``extract_aggregated_dataset`` bring home in
        a ``DescriptorCache`` there. ``mesh`` shards the batches' images
        over its ``data`` axis (module docstring); the extractor must have
        the ``_forward(params, images)`` hook. Where it has none the engine
        raises (the JAX engine warns and runs on one device)."""
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be 'float32' or 'uint8', got {transfer_dtype!r}")
        self.transfer_dtype = transfer_dtype
        self.batch_size = batch_size
        custom_extractor = extractor is not None
        if extractor is None:
            from anyloc_tpu_torch.models.factory import make_extractor

            extractor = make_extractor(
                model_type, desc_layer, desc_facet, checkpoint=checkpoint,
                dtype=dtype, use_cls=use_cls, norm_descs=norm_descs,
                quant=quant, device=device)
        if transfer_dtype == "uint8" and not getattr(extractor, "supports_uint8", False):
            raise ValueError(f"transfer_dtype='uint8' is not supported by "
                             f"{type(extractor).__name__}; use 'float32'")
        self.extractor = extractor
        self.patch = getattr(extractor.cfg, "patch_size", 14)
        self.mesh = mesh
        if mesh is not None and not hasattr(extractor, "_forward"):
            raise ValueError(f"mesh given but {type(extractor).__name__} has no sharded-"
                             "forward hook (_forward)")
        # the key names everything that changes the descriptors: the
        # checkpoint (random and real weights never share a cache) and, for
        # a caller's extractor, its class (the arguments do not describe it)
        self.desc_cache = None
        if cache_dir is not None:
            from anyloc_tpu_torch.utils.desc_cache import DescriptorCache

            cfg = {"model": model_type, "layer": desc_layer,
                   "facet": desc_facet, "use_cls": use_cls,
                   "norm": norm_descs, "dtype": str(dtype).removeprefix("torch."),
                   "transfer": transfer_dtype, "quant": quant,
                   "checkpoint": checkpoint}
            if custom_extractor:
                cfg["custom_extractor"] = type(extractor).__name__
            self.desc_cache = DescriptorCache(cache_dir, cfg)

    def _crop(self, images: np.ndarray) -> np.ndarray:
        return np.stack([center_crop_multiple(im, self.patch) for im in images])

    def _run(self, images: np.ndarray, aggregate=None) -> torch.Tensor:
        """One batch of cropped images -> the extractor's output (through
        ``aggregate`` when given) for every image, queued on the device;
        under the mesh each rank runs its block and the outputs gather."""
        if self.mesh is None:
            res = self.extractor(images)
            return aggregate(res) if aggregate is not None else res
        from anyloc_tpu_torch.parallel.distributed import sharded_extract_fn

        def apply(params, imgs):
            res = self.extractor._forward(params, imgs)
            return aggregate(res) if aggregate is not None else res

        out, n_valid = sharded_extract_fn(apply, self.mesh, as_numpy=False)(None, images)
        return out[:n_valid]

    def extract_batch(self, images: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] -> [B, P, D] float32 (center-cropped to the patch
        grid); under the mesh the patches of every rank's images gather."""
        return self._run(self._crop(images)).cpu().numpy()

    def _cached(self, key: str, n_items: int, compute) -> np.ndarray:
        """``desc_cache.get_or_compute``; under a mesh of several ranks
        every rank joins the computation (it is collective), rank 0 alone
        writes, and the others read what it wrote after a barrier."""
        import torch.distributed as dist

        if self.mesh is None or dist.get_world_size() == 1:
            return self.desc_cache.get_or_compute(key, n_items, compute)
        from anyloc_tpu_torch.parallel.mesh import barrier, broadcast_object

        rank0 = dist.get_rank() == 0
        hit = broadcast_object(self.desc_cache.has(key, n_items) if rank0 else None)
        out = None
        if not hit:
            out = compute()
            if rank0:
                if len(out) < n_items:
                    raise ValueError(f"compute() returned {len(out)} items but {n_items} "
                                     f"were promised for cache key {key!r}")
                self.desc_cache.write(key, out)
        barrier()
        return out if (rank0 and out is not None) else self.desc_cache.read(key, n_items)

    def _empty_shape(self, dataset) -> tuple:
        """(0, P, D) for an empty selection: P from the dataset's load size
        and the patch grid, D from the trunk."""
        cfg = self.extractor.cfg
        size = getattr(dataset, "img_size", None)
        p = 0
        if size is not None:
            crop = [s // self.patch * self.patch for s in size]
            grid = getattr(cfg, "grid", None)   # ViTConfig's, with a patch stride
            gh, gw = grid(*crop) if callable(grid) else [c // self.patch for c in crop]
            p = gh * gw
            p += 1 if getattr(self.extractor, "use_cls", False) else 0
        return (0, p, cfg.embed_dim)

    def extract_dataset(self, dataset, which: str = "all", sub_sample: int = 1,
                        verbose: bool = True, keep_on_device: bool = False):
        """-> [N, P, D] float32 patch descriptors of the selected items:
        numpy, or a tensor on the extractor's device with
        ``keep_on_device`` (no copy back and no cache; for results that
        feed more device work, such as the vocabulary k-means)."""
        idx = dataset.indices(which, sub_sample)
        if len(idx) == 0:
            empty = np.zeros(self._empty_shape(dataset), np.float32)
            return torch.from_numpy(empty).to(self.extractor.device) if keep_on_device else empty
        if self.desc_cache is not None and not keep_on_device:
            return self._cached(
                self._cache_key(dataset, which, sub_sample, idx), len(idx),
                lambda: self._extract_dataset(dataset, which, sub_sample, verbose))
        return self._extract_dataset(dataset, which, sub_sample, verbose,
                                     keep_on_device=keep_on_device)

    @staticmethod
    def _cache_key(dataset, which, sub_sample, idx) -> str:
        """The dataset's identity, not just its class: many dataset names
        map to one class (every domain recipe is a GlobalVocabDataset),
        so the digest covers the selected image paths and the load size."""
        h = hashlib.sha1()
        h.update(str(getattr(dataset, "img_size", None)).encode())
        for i in idx:
            h.update(str(dataset.images_paths[i]).encode())
            h.update(b"|")
        return (f"{type(dataset).__name__}_{which}_ss{sub_sample}_"
                f"{h.hexdigest()[:12]}")

    def extract_aggregated_dataset(self, dataset, aggregate, agg_key: str,
                                   which: str = "all", sub_sample: int = 1,
                                   verbose: bool = True) -> np.ndarray:
        """Extraction plus a device-side aggregation per batch:
        ``aggregate`` maps the [B, P, D] facets to what comes home (VLAD
        [B, C·D], ...); the patch tensor stays on the device. ``agg_key``
        names the aggregation in the descriptor cache."""
        if self.desc_cache is not None:
            idx = dataset.indices(which, sub_sample)
            return self._cached(
                f"{agg_key}_{self._cache_key(dataset, which, sub_sample, idx)}", len(idx),
                lambda: self._extract_dataset(dataset, which, sub_sample, verbose,
                                              aggregate=aggregate))
        return self._extract_dataset(dataset, which, sub_sample, verbose,
                                     aggregate=aggregate)

    def extract_vlads_dataset(self, dataset, vlad, which: str = "all",
                              sub_sample: int = 1, verbose: bool = True) -> np.ndarray:
        """Extraction + VLAD aggregation per batch -> [N, C·D] float32;
        only the VLAD vectors cross back to the host. ``vlad`` is fitted;
        its vocabulary digest is part of the cache key, so a refit never
        reads VLADs of other centers."""
        return self.extract_aggregated_dataset(
            dataset, vlad.aggregate, f"vlad{vlad.num_clusters}_{vlad.vocab_key()}",
            which, sub_sample, verbose)

    def _extract_dataset(self, dataset, which, sub_sample, verbose,
                         aggregate=None, keep_on_device=False):
        idx = dataset.indices(which, sub_sample)
        out = None
        done = 0
        parts = []

        def dispatch(imgs):
            return self._run(self._crop(imgs), aggregate)   # queued on the device

        def drain(pending):
            nonlocal out, done
            res, bidx = pending
            nv = int((bidx >= 0).sum())   # padding is a suffix of the batch
            if keep_on_device:
                parts.append(res[:nv])
            else:
                host = res[:nv].cpu().numpy()   # waits for this batch only
                if out is None:
                    out = np.empty((len(idx),) + host.shape[1:], np.float32)
                out[done:done + nv] = host
            done += nv
            if verbose:
                print(f"\rExtracting [{which}]: {done}/{len(idx)}", end="", flush=True)

        pending = None
        for imgs, bidx in dataset.batches(self.batch_size, which=which,
                                          sub_sample=sub_sample,
                                          output=self.transfer_dtype):
            cur = (dispatch(imgs), bidx)
            if pending is not None:
                drain(pending)
            pending = cur
        if pending is not None:
            drain(pending)
        if verbose:
            print()
        if keep_on_device:
            return torch.cat(parts)
        return out
