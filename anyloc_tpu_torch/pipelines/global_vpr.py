"""CLS-token global descriptor pipeline (counterpart of
``anyloc_tpu/pipelines/global_vpr.py``; reference
scripts/dino_v2_global_vpr.py extract_gd :119-131): the whole trunk's
final (post-norm) CLS embedding is the global descriptor."""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from anyloc_tpu_torch.config import PipelineArgs
from anyloc_tpu_torch.data.transforms import center_crop_multiple
from anyloc_tpu_torch.models.dinov2 import build_vit, dinov2_config, init_params, load_checkpoint
from anyloc_tpu_torch.models.extractor import resolve_dtype
from anyloc_tpu_torch.ops.common import resolve_device
from anyloc_tpu_torch.ops.retrieval import get_top_k_recall
from anyloc_tpu_torch.pipelines.vlad_pipeline import build_results_dict, dataset_from_args


class ClsEngine:
    """The whole trunk (every block and the final norm) on ``device``
    (None: the card), returning the post-norm CLS embedding. A
    ``checkpoint`` is a local DINOv2 ``.pth`` state dict, loaded natively;
    None means random weights from ``seed``."""

    def __init__(self, model_type: str, checkpoint: Optional[str] = None,
                 dtype="bfloat16", batch_size: int = 32,
                 device: Union[None, str, torch.device] = None, seed: int = 42):
        self.device = resolve_device(device)
        self.cfg = dinov2_config(model_type, dtype=resolve_dtype(dtype))
        if checkpoint is not None:
            params = load_checkpoint(checkpoint)
        else:
            params = init_params(self.cfg, seed, device=self.device)
        self.model = build_vit(self.cfg, params, None, device=self.device)
        self.batch_size = batch_size

    @torch.inference_mode()
    def __call__(self, imgs) -> torch.Tensor:
        """[B, H, W, 3] normalized float images -> [B, D] float32 CLS."""
        x = torch.as_tensor(np.asarray(imgs, np.float32)).to(self.device)
        return self.model(x)["cls"].float()

    def extract_dataset(self, dataset, which="all", sub_sample=1, verbose=True) -> np.ndarray:
        idx = dataset.indices(which, sub_sample)
        out = None
        done = 0
        for imgs, bidx in dataset.batches(self.batch_size, which=which, sub_sample=sub_sample):
            imgs = np.stack([center_crop_multiple(im, self.cfg.patch_size) for im in imgs])
            cls = self(imgs).cpu().numpy()
            if out is None:
                out = np.empty((len(idx), cls.shape[-1]), np.float32)
            valid = bidx >= 0
            out[done:done + valid.sum()] = cls[valid]
            done += int(valid.sum())
            if verbose:
                print(f"\rExtracting CLS [{which}]: {done}/{len(idx)}", end="", flush=True)
        if verbose:
            print()
        return out


def run_global_vpr(largs: PipelineArgs, dataset=None, engine: Optional[ClsEngine] = None,
                   verbose: bool = True, device=None) -> Dict:
    """``device`` places the engine built from ``largs`` (None: the card;
    an ``engine`` given keeps its own). Retrieval runs on the engine's
    device."""
    if largs.extractor.quant or largs.extractor.transfer_dtype != "float32":
        # the serving flags apply to the facet-extractor pipelines only;
        # refusing beats running full precision while the user believes
        # otherwise
        raise ValueError(
            "extractor.quant / extractor.transfer_dtype are not supported "
            "by this pipeline")
    ds_name = largs.prog.vg_dataset_name
    if dataset is None:
        dataset = dataset_from_args(largs, ds_name)
    if engine is None:
        engine = ClsEngine(largs.extractor.model_type, largs.extractor.checkpoint,
                           largs.extractor.dtype, largs.extractor.batch_size, device=device)
    db_g = engine.extract_dataset(dataset, "db", largs.sub_sample_db, verbose)
    qu_g = engine.extract_dataset(dataset, "queries", largs.sub_sample_qu, verbose)
    dists, indices, recalls = get_top_k_recall(
        largs.top_k_vals, db_g, qu_g, dataset.get_positives(),
        sub_sample_db=largs.sub_sample_db, sub_sample_qu=largs.sub_sample_qu,
        device=engine.device,
    )
    results = build_results_dict(largs, db_g, qu_g, recalls, ds_name, agg="CLS")
    results["Qual-Dists"] = dists
    results["Qual-Indices"] = indices
    return results
