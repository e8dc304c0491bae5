"""Triplet mining (counterpart of ``anyloc_tpu/training/mining.py``; the
TripletsDataset logic of ``dvgl_benchmark/datasets_ws.py:272-506``):

  * ``random``: negatives drawn uniformly outside the positive set;
  * ``partial``: descriptors of the chosen queries and of a random subset of
    the database each refresh; the hardest negatives within the subset;
  * ``full``: the whole database; the hardest negatives overall;
  * ``msls_weighted``: ``partial`` with night and sideways queries drawn
    more often (Mapillary SLS).

The per-query tuple is (query, closest positive, neg_num hardest
negatives). The host logic and its numpy RNG are the JAX module's, so the
same descriptors give the same triplets; the nearest-neighbour search is
the port's ``top_k_search`` on ``device`` (None: the card).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from anyloc_tpu_torch.ops.common import resolve_device
from anyloc_tpu_torch.ops.retrieval import top_k_search


class TripletMiner:
    def __init__(self, dataset, neg_num: int = 10, mining: str = "partial",
                 neg_samples_num: int = 1000, seed: int = 42, *,
                 device: Union[None, str, torch.device] = None) -> None:
        assert mining in ("random", "partial", "full", "msls_weighted"), mining
        self.ds = dataset
        self.neg_num = neg_num
        self.mining = mining
        self.neg_samples_num = neg_samples_num
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        # queries with at least one positive (datasets_ws.py:300-308)
        pos = dataset.get_positives()
        self.valid_queries = [i for i, p in enumerate(pos) if len(p) > 0]
        self.query_weights = None
        if mining == "msls_weighted":
            # night and sideways queries over-sampled inversely to their
            # frequency (datasets_ws.py:322-337)
            night = np.asarray(getattr(dataset, "night_indexes", []), int)
            side = np.asarray(getattr(dataset, "sideways_indexes", []), int)
            if len(night) == 0 and len(side) == 0:
                raise RuntimeError(
                    "msls_weighted mining needs a dataset exposing "
                    "night_indexes / sideways_indexes (Mapillary SLS)")
            nq = dataset.queries_num
            w = np.ones(nq)
            if len(night):
                w[night] += nq / len(night)
            if len(side):
                w[side] += nq / len(side)
            self.query_weights = w / w.sum()

    def _extract(self, descriptor_fn, indices: np.ndarray, batch_size: int) -> np.ndarray:
        """Descriptors [len(indices), D] float32, ``batch_size`` images a
        call, the last chunk padded to a whole batch as the JAX module does
        (one shape per descriptor_fn)."""
        feats = None
        for s in range(0, len(indices), batch_size):
            chunk = np.asarray(indices[s:s + batch_size])
            n = len(chunk)
            if n < batch_size:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - n)])
            imgs = np.stack([self.ds[i][0] for i in chunk])
            f = descriptor_fn(imgs)
            f = (f.detach().float().cpu().numpy() if isinstance(f, torch.Tensor)
                 else np.asarray(f, np.float32))[:n]
            if feats is None:
                feats = np.empty((len(indices), f.shape[-1]), np.float32)
            feats[s:s + n] = f
        return feats

    def compute_triplets(self, descriptor_fn: Callable[[np.ndarray], np.ndarray],
                         n_queries: int = 1000, batch_size: int = 16
                         ) -> List[Tuple[int, int, np.ndarray]]:
        """-> list of (query_idx, positive_idx, negative_idxs [neg_num])
        (dataset-global indices; queries offset by database_num)."""
        weights = None
        if self.query_weights is not None:
            w = self.query_weights[self.valid_queries]
            weights = w / w.sum()
        qsel = self.rng.choice(self.valid_queries, size=min(n_queries, len(self.valid_queries)),
                               replace=False, p=weights)
        positives = self.ds.get_positives()
        db_num = self.ds.database_num

        if self.mining == "random":
            out = []
            for q in qsel:
                pos = np.asarray(positives[q])
                p = int(self.rng.choice(pos))
                negs = []
                while len(negs) < self.neg_num:
                    cand = int(self.rng.integers(0, db_num))
                    if cand not in pos:
                        negs.append(cand)
                out.append((db_num + q, p, np.asarray(negs)))
            return out

        # partial / full: cache features, mine the hardest
        if self.mining == "full":
            neg_pool = np.arange(db_num)
        else:
            neg_pool = self.rng.choice(db_num, size=min(self.neg_samples_num, db_num),
                                       replace=False)
        qu_feats = self._extract(descriptor_fn, db_num + qsel, batch_size)
        pool_feats = self._extract(descriptor_fn, neg_pool, batch_size)
        # best positive = the closest positive in feature space; every
        # positive of the chosen queries extracts in one pass
        all_pos = np.unique(np.concatenate([np.asarray(positives[q]) for q in qsel]))
        pos_row = {int(p): r for r, p in enumerate(all_pos)}
        all_pos_feats = self._extract(descriptor_fn, all_pos, batch_size)
        out = []
        k = min(self.neg_num + 50, len(neg_pool))
        _, knn = top_k_search(torch.from_numpy(pool_feats).to(self.device),
                              torch.from_numpy(qu_feats).to(self.device), k, method="l2")
        knn = knn.cpu().numpy()
        for row, q in enumerate(qsel):
            pos = np.asarray(positives[q])
            pos_feats = all_pos_feats[[pos_row[int(p)] for p in pos]]
            d = ((pos_feats - qu_feats[row]) ** 2).sum(-1)
            best_pos = int(pos[np.argmin(d)])
            negs = []
            for cand in neg_pool[knn[row]]:
                if cand not in pos:
                    negs.append(int(cand))
                if len(negs) == self.neg_num:
                    break
            while len(negs) < self.neg_num:  # fallback: random fill
                cand = int(self.rng.integers(0, db_num))
                if cand not in pos and cand not in negs:
                    negs.append(cand)
            out.append((db_num + q, best_pos, np.asarray(negs)))
        return out

    def tuples_as_batch(self, triplets, indices: Sequence[int]) -> np.ndarray:
        """Image tuples [B, 2 + neg_num, H, W, 3] for a train step."""
        batch = []
        for i in indices:
            q, p, negs = triplets[i]
            imgs = [self.ds[q][0], self.ds[p][0]] + [self.ds[int(n)][0] for n in negs]
            batch.append(np.stack(imgs))
        return np.stack(batch)
