"""VLAD aggregation and the reference's ``VLAD`` API (counterpart of
``anyloc_tpu/ops/vlad.py``).

Per image, descriptors x [N, D], centers c [C, D]:

  hard:  a[n, k] = one_hot(argmax_k sim(x_n, c_k))      (sim per dist_mode)
  soft:  a[n, k] = softmax_k(temp * cos(x_n, c_k))
  V[k]   = sum_n a[n, k] (x_n - c_k)   (soft: C·wsum - counts·sum_c c)
  V[k]  /= |V[k]| if intra_norm;  out = flatten(V) / |flatten(V)|  [C·D]

Unmasked CUDA batches run K1 (``ops/kernels/vlad_kernel.py``); CPU
batches and masked batches run the plain path below, as in the JAX
package. The vocabulary cache is ``c_centers.npz`` (key "centers"),
written atomically, so a vocabulary fitted by either package loads in the
other; a reference-exported ``c_centers.pt`` (a tensor written with
``torch.save``) is read when no ``c_centers.npz`` is there. The residual
API (``vlad_residuals``, ``VLAD.generate_res_vec`` and
``generate_multi_res_vec``) caches ``<id>_r.npz`` (key "res");
``generate_multi_res_vec`` passes its ``cache_ids`` on (the JAX package
drops them, F3).
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import l2_normalize
from anyloc_tpu_torch.ops.kernels import vlad_aggregate_fused
from anyloc_tpu_torch.ops.kernels.vlad_kernel import zero_noise_residuals
from anyloc_tpu_torch.ops.kmeans import KMeans, _similarity


def _save_npz_atomic(path: str, **arrays) -> None:
    """Publish an .npz atomically (tmp + os.replace): a killed run never
    leaves a torn cache file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    np.savez(tmp, **arrays)          # np.savez appends .npz to the target
    os.replace(tmp + ".npz", path)


def _load_npz_or_none(path: str):
    """Dict of arrays, or None when the file is missing or torn (a miss)."""
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def _as_f32(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device if device is not None else t.device, dtype=torch.float32)


def vlad_assign(descs: torch.Tensor, centers: torch.Tensor, *,
                vlad_mode: str = "hard", dist_mode: str = "cosine",
                soft_temp: float = 1.0) -> torch.Tensor:
    """Assignment weights [..., N, C] for descs [..., N, D]."""
    c = centers.shape[0]
    if vlad_mode == "hard":
        sim = _similarity(descs.reshape(-1, descs.shape[-1]), centers, dist_mode)
        a = torch.nn.functional.one_hot(sim.argmax(-1), c).float()
        return a.reshape(*descs.shape[:-1], c)
    if vlad_mode == "soft":
        # the reference's soft assignment is cosine whatever dist_mode
        cos = l2_normalize(descs) @ l2_normalize(centers).T
        return torch.softmax(soft_temp * cos, dim=-1)
    raise ValueError(f"Unknown vlad_mode: {vlad_mode}")


def vlad_aggregate(
    descs: torch.Tensor,
    centers: torch.Tensor,
    *,
    vlad_mode: str = "hard",
    dist_mode: str = "cosine",
    intra_norm: bool = True,
    norm_descs: bool = True,
    soft_temp: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Batched VLAD. descs [B, N, D] (or [N, D]), centers [C, D] ->
    [B, C·D] float32. ``mask`` [B, N] zeroes padded tokens. ``impl``:
    "auto" (or "pallas", the JAX name) launches K1 for an unmasked batch on
    the card; "xla" takes the plain torch path on every device."""
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got {impl!r}")
    squeeze = descs.dim() == 2
    if squeeze:
        descs = descs[None]
    centers = centers.to(descs.device)
    if mask is None and descs.is_cuda and impl != "xla":
        out = vlad_aggregate_fused(
            descs.float().contiguous(), centers, dist_mode=dist_mode,
            intra_norm=intra_norm, norm_descs=norm_descs, vlad_mode=vlad_mode,
            soft_temp=soft_temp)
        return out[0] if squeeze else out
    b, n, d = descs.shape
    c = centers.shape[0]
    x = descs.float()
    centers = centers.float()
    if norm_descs:
        x = l2_normalize(x)
    # cosine labels are scale-invariant, so assigning on the normalized copy
    # matches the reference's predict-on-raw (euclidean + norm_descs differs
    # and is documented in the JAX package)
    a = vlad_assign(x, centers, vlad_mode=vlad_mode, dist_mode=dist_mode,
                    soft_temp=soft_temp)
    if mask is not None:
        a = a * mask.to(a.device, a.dtype)[..., None]
    wsum = a.transpose(1, 2) @ x                      # [B, C, D]
    counts = a.sum(1)
    if vlad_mode == "hard":
        v = zero_noise_residuals(wsum - counts[..., None] * centers[None], counts, centers)
    else:
        v = c * wsum - counts[..., None] * centers.sum(0)
    if intra_norm:
        v = l2_normalize(v)
    out = l2_normalize(v.reshape(b, c * d))
    return out[0] if squeeze else out


def vlad_residuals(descs: torch.Tensor, centers: torch.Tensor, *,
                   norm_descs: bool = True) -> torch.Tensor:
    """The full residual tensor [..., N, C, D] (the reference's
    ``generate_res_vec``): API parity and visualization only, the
    aggregation never builds it."""
    x = l2_normalize(descs) if norm_descs else descs
    return x[..., :, None, :] - centers.to(x.device)[None, :, :]


class VLAD:
    """The reference ``VLAD`` API (fit / fit_and_generate / generate /
    generate_multi, and the residual API) over batched aggregation. Results
    are torch tensors on the descriptors' device; the per-image cache
    stores ``<id>_v.npz``, the residual API ``<id>_r.npz``."""

    def __init__(
        self,
        num_clusters: int,
        desc_dim: Optional[int] = None,
        intra_norm: bool = True,
        norm_descs: bool = True,
        dist_mode: str = "cosine",
        vlad_mode: str = "hard",
        soft_temp: float = 1.0,
        cache_dir: Optional[str] = None,
        seed: int = 42,
    ) -> None:
        self.num_clusters = num_clusters
        self.desc_dim = desc_dim
        self.intra_norm = intra_norm
        self.norm_descs = norm_descs
        self.mode = dist_mode
        self.vlad_mode = str(vlad_mode).lower()
        if self.vlad_mode not in ("soft", "hard"):
            raise ValueError(f"vlad_mode must be 'hard' or 'soft', got {vlad_mode!r}")
        self.soft_temp = soft_temp
        self.seed = seed
        self.c_centers: Optional[torch.Tensor] = None
        self.kmeans: Optional[KMeans] = None
        self.cache_dir = cache_dir
        if self.cache_dir is not None:
            self.cache_dir = os.path.abspath(os.path.expanduser(self.cache_dir))
            os.makedirs(self.cache_dir, exist_ok=True)

    def _centers_path(self) -> str:
        return f"{self.cache_dir}/c_centers.npz"

    def _centers_pt_path(self) -> str:
        return f"{self.cache_dir}/c_centers.pt"

    def can_use_cache_vlad(self) -> bool:
        return self.cache_dir is not None and (os.path.exists(self._centers_path())
                                               or os.path.exists(self._centers_pt_path()))

    def can_use_cache_ids(self, cache_ids: Union[List[str], str, None],
                          only_residuals: bool = False) -> bool:
        """Whether every id has a cached result: ``<id>_v.npz`` (the global
        descriptor), or ``<id>_r.npz`` with ``only_residuals`` (what
        ``generate_res_vec`` reads and writes)."""
        if not self.can_use_cache_vlad() or cache_ids is None:
            return False
        if isinstance(cache_ids, str):
            cache_ids = [cache_ids]
        suffix = "_r.npz" if only_residuals else "_v.npz"
        return all(os.path.exists(f"{self.cache_dir}/{cid}{suffix}") for cid in cache_ids)

    def _load_cached_centers(self) -> Optional[torch.Tensor]:
        """The cached vocabulary: ``c_centers.npz``, else the reference's
        ``c_centers.pt``; None when the npz is torn and no .pt is there."""
        if os.path.exists(self._centers_path()):
            z = _load_npz_or_none(self._centers_path())
            if z is not None and "centers" in z:
                return torch.from_numpy(np.asarray(z["centers"], np.float32))
            if not os.path.exists(self._centers_pt_path()):
                return None
        t = torch.load(self._centers_pt_path(), map_location="cpu", weights_only=True)
        return t.detach().float().cpu()

    def fit(self, train_descs=None) -> None:
        """Build (or load from ``cache_dir``) the vocabulary.
        ``train_descs``: [num_desc, D] (torch or numpy), or None when a
        cached vocabulary exists."""
        self.kmeans = KMeans(self.num_clusters, mode=self.mode, seed=self.seed)
        if self.can_use_cache_vlad():
            centers = self._load_cached_centers()
            if centers is None and train_descs is None:
                raise ValueError(
                    f"cached vocabulary at {self.cache_dir} is unreadable "
                    "(torn write?) and no training descriptors were given")
            if centers is not None:
                if centers.shape[0] != self.num_clusters:
                    raise ValueError(
                        f"cached vocabulary at {self.cache_dir} has "
                        f"{centers.shape[0]} clusters, not {self.num_clusters}")
                if self.desc_dim is not None and centers.shape[1] != self.desc_dim:
                    raise ValueError(f"cached vocabulary dim {centers.shape[1]} "
                                     f"!= desc_dim {self.desc_dim}")
                self.c_centers = centers
                self.kmeans.centroids = centers
                self.desc_dim = int(centers.shape[1])
                return
        if train_descs is None:
            raise ValueError("No training descriptors given and no cache")
        x = _as_f32(train_descs)
        if self.desc_dim is None:
            self.desc_dim = int(x.shape[1])
        if self.norm_descs:
            x = l2_normalize(x)
        self.kmeans.fit(x)
        self.c_centers = self.kmeans.centroids
        if self.cache_dir is not None:
            _save_npz_atomic(self._centers_path(),
                             centers=self.c_centers.cpu().numpy())

    def fit_and_generate(self, train_descs) -> torch.Tensor:
        """[num_imgs, N, D] -> fit on all descriptors -> [num_imgs, C·D]."""
        x = _as_f32(train_descs)
        self.fit(x.reshape(-1, x.shape[-1]))
        return self.generate_multi(x)

    def aggregate(self, descs: torch.Tensor, mask=None) -> torch.Tensor:
        """[B, N, D] -> [B, C·D] on the descriptors' device; the engine's
        fused extract + aggregate entry point."""
        if self.c_centers is None:
            raise RuntimeError("Call fit() before generate()")
        return vlad_aggregate(
            descs, self.c_centers, vlad_mode=self.vlad_mode,
            dist_mode=self.mode, intra_norm=self.intra_norm,
            norm_descs=self.norm_descs, soft_temp=self.soft_temp, mask=mask)

    def vocab_key(self) -> str:
        """Digest of the vocabulary and the aggregation settings."""
        if self.c_centers is None:
            raise RuntimeError("Call fit() first")
        h = hashlib.sha1(self.c_centers.detach().cpu().numpy().astype(np.float32).tobytes())
        h.update(f"{self.vlad_mode}_{self.mode}_{self.intra_norm}_"
                 f"{self.norm_descs}_{self.soft_temp}".encode())
        return h.hexdigest()[:12]

    def _v_path(self, cache_id: str) -> str:
        return f"{self.cache_dir}/{cache_id}_v.npz"

    def _load_v(self, cache_id) -> Optional[np.ndarray]:
        if cache_id is None or self.cache_dir is None:
            return None
        z = _load_npz_or_none(self._v_path(cache_id))
        return None if z is None or "vlad" not in z else z["vlad"]

    def _save_v(self, cache_id, vlad: torch.Tensor) -> None:
        if cache_id is not None and self.cache_dir is not None:
            _save_npz_atomic(self._v_path(cache_id), vlad=vlad.cpu().numpy())

    def generate(self, query_descs, cache_id: Optional[str] = None) -> torch.Tensor:
        """[N, D] -> [C·D]; ``cache_id`` stores/loads the result."""
        hit = self._load_v(cache_id)
        if hit is not None:
            return torch.from_numpy(hit)
        out = self.aggregate(_as_f32(query_descs))
        self._save_v(cache_id, out)
        return out

    def generate_multi(self, multi_query: Union[torch.Tensor, Sequence],
                       cache_ids: Optional[List[str]] = None) -> torch.Tensor:
        """[B, N, D] (or a list of [N_i, D]) -> [B, C·D]. A ragged list is
        padded per power-of-two length bucket and masked."""
        if isinstance(multi_query, (list, tuple)):
            if not all(q.shape == multi_query[0].shape for q in multi_query):
                return self._generate_ragged(list(multi_query), cache_ids)
            multi_query = torch.stack([_as_f32(q) for q in multi_query])
        if cache_ids is not None and self.cache_dir is not None:
            hits = [self._load_v(cid) for cid in cache_ids]
            if all(h is not None for h in hits):
                return torch.from_numpy(np.stack(hits))
        out = self.aggregate(_as_f32(multi_query))
        if cache_ids is not None and self.cache_dir is not None:
            for cid, v in zip(cache_ids, out):
                self._save_v(cid, v)
        return out

    def _generate_ragged(self, queries: List, cache_ids) -> torch.Tensor:
        cache_ids = cache_ids if cache_ids is not None else [None] * len(queries)
        queries = [_as_f32(q) for q in queries]
        d = queries[0].shape[-1]
        dev = queries[0].device

        def bucket(n):
            b = 64
            while b < n:
                b *= 2
            return b

        out = torch.zeros((len(queries), self.num_clusters * d), dtype=torch.float32, device=dev)
        by_bucket = {}
        for i, q in enumerate(queries):
            hit = self._load_v(cache_ids[i])
            if hit is not None and hit.shape == tuple(out[i].shape):
                out[i] = torch.from_numpy(hit).to(dev)
                continue
            by_bucket.setdefault(bucket(q.shape[0]), []).append(i)
        for bsize, idxs in by_bucket.items():
            padded = torch.zeros((len(idxs), bsize, d), dtype=torch.float32, device=dev)
            mask = torch.zeros((len(idxs), bsize), dtype=torch.float32, device=dev)
            for j, i in enumerate(idxs):
                n = queries[i].shape[0]
                padded[j, :n] = queries[i].to(dev)
                mask[j, :n] = 1.0
            res = self.aggregate(padded, mask=mask)
            for j, i in enumerate(idxs):
                out[i] = res[j]
                self._save_v(cache_ids[i], out[i])
        return out

    # -- the residual API (the reference's generate_res_vec) -----------------
    def generate_res_vec(self, query_descs, cache_id: Optional[str] = None) -> torch.Tensor:
        """[N, D] -> residuals [N, C, D]; ``cache_id`` stores/loads
        ``<id>_r.npz``."""
        if self.c_centers is None:
            raise RuntimeError("Call fit() before generate_res_vec()")
        path = None if cache_id is None or self.cache_dir is None else \
            f"{self.cache_dir}/{cache_id}_r.npz"
        if path is not None:
            z = _load_npz_or_none(path)
            if z is not None and "res" in z:
                return torch.from_numpy(z["res"])
        res = vlad_residuals(_as_f32(query_descs), self.c_centers.float(),
                             norm_descs=self.norm_descs)
        if path is not None:
            _save_npz_atomic(path, res=res.cpu().numpy())
        return res

    def generate_multi_res_vec(self, multi_query, cache_ids: Optional[List[str]] = None
                               ) -> torch.Tensor:
        """[B, N, D] (or a list of [N, D]) -> [B, N, C, D], each image
        through ``generate_res_vec`` with its cache id (F3: the JAX package
        drops ``cache_ids`` here)."""
        ids = cache_ids if cache_ids is not None else [None] * len(multi_query)
        return torch.stack([self.generate_res_vec(q, cid) for q, cid in zip(multi_query, ids)])
