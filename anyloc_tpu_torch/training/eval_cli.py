"""Checkpoint evaluation (counterpart of ``anyloc_tpu/training/eval_cli.py``;
dvgl ``eval.py``): a trained GeoLocalizationNet, or with ``--model-family
mixvpr | cosplace`` the MixVPR / CosPlace release models
(``MixVPR/mixer_top_k_vpr.py``, ``CosPlace/test.py``), evaluated on a
dataset of the registry. Runs on the card unless the caller names a
device (``main(argv, device="cpu")``).

Weights: ``--checkpoint`` a ``.pth`` / ``.pt`` (/ ``.ckpt`` for the
families) release state dict through the converters (dvgl: the
torchvision ResNet backbone, the aggregation from the random init), or a
file of the port's ``utils.checkpoint.save_checkpoint``; none means a
random init drawn on the CPU from seed 0 (``torch.Generator``; the JAX
CLI's ``PRNGKey(0)`` draw is not reproducible in torch, F2).

Usage:
  python -m anyloc_tpu_torch eval --checkpoint ckpt/best_checkpoint \\
      --backbone resnet18conv4 --aggregation netvlad \\
      --dataset gardens --datasets-folder /data/vpr
  python -m anyloc_tpu_torch eval --model-family mixvpr \\
      --checkpoint resnet50_MixVPR_4096.ckpt --dataset gardens \\
      --datasets-folder /data/vpr
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from anyloc_tpu_torch.models.convert import materialize
from anyloc_tpu_torch.ops.common import resolve_device

SEED = 0


def load_model_params(args, model):
    """The state dict ``model`` (the CLI's random init) takes from
    ``--checkpoint``: its own with no checkpoint; a ``.pth`` / ``.pt``
    grafts the torchvision ResNet backbone into it; any other path is a
    ``save_checkpoint`` file."""
    sd = model.state_dict()
    if args.checkpoint is None:
        return sd
    if args.checkpoint.endswith((".pth", ".pt")):
        from anyloc_tpu_torch.models.convert import load_torch_checkpoint, strip_prefix
        from anyloc_tpu_torch.models.resnet import (convert_torchvision_resnet, resnet18_config,
                                                    resnet50_config, resnet101_config)

        tv = strip_prefix(strip_prefix(load_torch_checkpoint(args.checkpoint), "module."),
                          "backbone.")
        fac = {"resnet18": resnet18_config, "resnet50": resnet50_config,
               "resnet101": resnet101_config}[args.backbone.rstrip("conv45")]
        trunc = "conv4" if args.backbone.endswith("conv4") else "conv5"
        bb = convert_torchvision_resnet(tv, fac(truncate=trunc))
        return {**sd, **{f"backbone.{k}": v for k, v in bb.items()}}
    from anyloc_tpu_torch.utils.checkpoint import load_checkpoint

    state = load_checkpoint(args.checkpoint)
    return state["params"] if "params" in state else state


def _build_family_model(args):
    """mixvpr / cosplace: (the VPRModel, random from seed 0, on the CPU; its
    state dict from ``--checkpoint``)."""
    from anyloc_tpu_torch.training.mixvpr import (VPRModel, convert_cosplace_checkpoint,
                                                  convert_mixvpr_checkpoint, get_backbone)

    backbone = args.backbone
    if backbone == "resnet18conv4":   # the dvgl default does not apply
        backbone = "resnet50"
    if args.model_family == "mixvpr":
        def make():
            return VPRModel(backbone=backbone, agg_arch="mixvpr",
                            agg_config={"out_channels": args.mix_out_channels,
                                        "out_rows": args.mix_out_rows,
                                        "mix_depth": args.mix_depth},
                            input_hw=args.resize)
        convert = convert_mixvpr_checkpoint
    else:
        with torch.device("meta"):
            _, ch = get_backbone(backbone, layers_to_crop=())

        def make():
            return VPRModel(backbone=backbone, layers_to_crop=(), agg_arch="cosplace",
                            agg_config={"in_dim": ch, "out_dim": args.fc_output_dim},
                            input_hw=args.resize)

        def convert(sd):
            return convert_cosplace_checkpoint(sd, backbone=backbone)

    model = materialize(make, None, "cpu", seed=SEED)
    if args.checkpoint is None:
        sd = model.state_dict()
    elif args.checkpoint.endswith((".pth", ".pt", ".ckpt")):
        from anyloc_tpu_torch.models.convert import load_torch_checkpoint

        sd = convert(load_torch_checkpoint(args.checkpoint))
    else:
        from anyloc_tpu_torch.utils.checkpoint import load_checkpoint

        state = load_checkpoint(args.checkpoint)
        sd = state["params"] if "params" in state else state
    return model, sd


def main(argv=None, device=None) -> int:
    """``device`` places the model and the search (None: the card); it is
    for callers such as tests, not a flag."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--model-family", default="dvgl", choices=["dvgl", "mixvpr", "cosplace"])
    p.add_argument("--backbone", default="resnet18conv4")
    p.add_argument("--aggregation", default="netvlad")
    p.add_argument("--netvlad-clusters", type=int, default=64)
    p.add_argument("--fc-output-dim", type=int, default=512,
                   help="cosplace descriptor dim (CosPlace --fc_output_dim)")
    p.add_argument("--mix-out-channels", type=int, default=1024)
    p.add_argument("--mix-out-rows", type=int, default=4)
    p.add_argument("--mix-depth", type=int, default=4)
    p.add_argument("--dataset", required=True)
    p.add_argument("--datasets-folder", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--resize", type=int, nargs=2, default=None,
                   help="default: 480 640 (dvgl), or 320 320 for --model-family mixvpr (the "
                        "release checkpoints' training resolution: the mixer weights are "
                        "token-count-specific)")
    p.add_argument("--test-method", default="hard_resize")
    p.add_argument("--recall-values", type=int, nargs="*", default=[1, 5, 10, 20])
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--efficient-ram-testing", action="store_true")
    p.add_argument("--majority-weight", type=float, default=0.01)
    p.add_argument("--save-descs", default=None,
                   help="save all descriptors (db rows first, then queries) as <path>.npy "
                        "(dvgl --save_descs)")
    p.add_argument("--pca-dim", type=int, default=None)
    p.add_argument("--pca-dataset-folder", default=None,
                   help="image dir whose features fit the PCA (dvgl --pca_dataset_folder)")
    args = p.parse_args(argv)
    if args.pca_dim is not None and args.pca_dataset_folder is None:
        p.error("specify --pca-dataset-folder when using --pca-dim (parser.py:135-136)")
    if args.resize is None:
        args.resize = (320, 320) if args.model_family == "mixvpr" else (480, 640)
    args.resize = tuple(args.resize)
    dev = resolve_device(device)

    from anyloc_tpu_torch.data.registry import get_dataset
    from anyloc_tpu_torch.training.evaluate import evaluate

    if args.model_family != "dvgl":
        model, sd = _build_family_model(args)
    else:
        from anyloc_tpu_torch.training.network import GeoLocalizationNet

        model = materialize(lambda: GeoLocalizationNet(
            backbone=args.backbone, aggregation=args.aggregation,
            netvlad_clusters=args.netvlad_clusters, img_size=args.resize[0]), None, "cpu",
            seed=SEED)
        sd = load_model_params(args, model)
    model.load_state_dict(sd, strict=True)
    model = model.to(dev)
    ds = get_dataset(args.dataset, args.datasets_folder, args.split, img_size=args.resize)

    @torch.inference_mode()
    def desc_fn(imgs):
        return model(torch.as_tensor(np.asarray(imgs, np.float32)).to(dev))

    pca = None
    if args.pca_dim is not None:
        # dvgl util.compute_pca: forward the PCA folder's images, fit PCA
        import glob
        import os

        from anyloc_tpu_torch.data.base import VPRDataset, natsorted
        from anyloc_tpu_torch.ops.pca import pca_fit

        paths = natsorted([q for e in ("*.jpg", "*.jpeg", "*.png")
                           for q in glob.glob(os.path.join(args.pca_dataset_folder, e))])
        if not paths:
            raise FileNotFoundError(f"no images in {args.pca_dataset_folder}")
        pca_ds = VPRDataset(paths, [], img_size=args.resize)
        feats = [desc_fn(imgs)[torch.from_numpy(bidx >= 0).to(dev)]
                 for imgs, bidx in pca_ds.batches(args.batch_size, which="db")]
        pca = pca_fit(torch.cat(feats).float(), args.pca_dim)
    recalls, recalls_str = evaluate(
        desc_fn, ds, test_method=args.test_method, recall_values=args.recall_values,
        batch_size=args.batch_size, pca=pca, majority_weight=args.majority_weight,
        efficient_ram=args.efficient_ram_testing, save_descs=args.save_descs, device=dev)
    print(recalls_str)
    print(json.dumps({f"R@{k}": float(r) for k, r in zip(args.recall_values, recalls)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
