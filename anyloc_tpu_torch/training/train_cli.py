"""Training CLI (counterpart of ``anyloc_tpu/training/train_cli.py``): the
dvgl ``train.py`` surface (parser.py's core flags) over the port's triplet
loop, on the card.

  python -m anyloc_tpu_torch train --dataset pitts30k \\
      --datasets-folder /data/vpr --backbone resnet18conv4 \\
      --aggregation netvlad --mining partial --epochs 3 \\
      --output-dir ./runs/exp1

The model starts from a random init drawn on the CPU from ``--seed``
(``models.convert.random_init_``; no pretrained weights are read), or
with ``--resume`` from ``<output-dir>/last_checkpoint``, which holds the
parameters, the epoch and the best Recall@5; like the JAX CLI it restarts
at epoch 0 with best R@5 0 (F20).
"""

from __future__ import annotations

import argparse
import logging


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--datasets-folder", required=True)
    p.add_argument("--val-dataset", default=None, help="defaults to --dataset val split")
    p.add_argument("--backbone", default="resnet18conv4",
                   choices=["alexnet", "vgg16", "resnet18conv4", "resnet18conv5",
                            "resnet50conv4", "resnet50conv5", "resnet101conv4",
                            "resnet101conv5", "cct384", "vit"])
    p.add_argument("--aggregation", default="netvlad",
                   choices=["netvlad", "crn", "rrm", "gem", "mac", "spoc", "rmac", "cls",
                            "seqpool"])
    p.add_argument("--netvlad-clusters", type=int, default=64)
    p.add_argument("--fc-output-dim", type=int, default=None)
    p.add_argument("--trunc-te", type=int, default=None, choices=list(range(0, 14)),
                   help="truncate cct384/vit at this transformer encoder")
    p.add_argument("--freeze-te", type=int, default=None, choices=list(range(-1, 14)),
                   help="freeze transformer encoders up to this index (optimizer mask)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block of the 'vit' backbone in the "
                        "backward (activation memory)")
    p.add_argument("--mining", default="partial",
                   choices=["random", "partial", "full", "msls_weighted"])
    p.add_argument("--neg-samples-num", type=int, default=1000,
                   help="negatives pool size for hardest-negative search")
    p.add_argument("--criterion", default="triplet",
                   choices=["triplet", "sare_ind", "sare_joint"])
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--neg-num", type=int, default=10)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--patience", type=int, default=3,
                   help="early-stop epochs without R@5 improvement")
    p.add_argument("--optim", default="adam", choices=["adam", "sgd"])
    p.add_argument("--queries-per-epoch", type=int, default=5000)
    p.add_argument("--cache-refresh-every", type=int, default=1000)
    p.add_argument("--train-batch-size", type=int, default=4)
    p.add_argument("--infer-batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--resize", type=int, nargs=2, default=(480, 640))
    p.add_argument("--test-method", default="hard_resize",
                   choices=["hard_resize", "single_query", "central_crop", "five_crops",
                            "nearest_crop", "maj_voting"])
    p.add_argument("--efficient-ram-testing", action="store_true")
    p.add_argument("--recall-values", type=int, nargs="*", default=[1, 5, 10, 20])
    # train-time augmentation (the reference parser's data-augmentation
    # block; applied on the card to each batch's queries, data/augment.py)
    p.add_argument("--brightness", type=float, default=0)
    p.add_argument("--contrast", type=float, default=0)
    p.add_argument("--saturation", type=float, default=0)
    p.add_argument("--hue", type=float, default=0)
    p.add_argument("--horizontal-flip", action="store_true")
    p.add_argument("--random-resized-crop", type=float, default=0)
    p.add_argument("--rand-perspective", type=float, default=0)
    p.add_argument("--random-rotation", type=float, default=0)
    p.add_argument("--output-dir", default="./runs/default")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--netvlad-init-samples", type=int, default=0,
                   help=">0: k-means-initialize NetVLAD centroids from this many database "
                        "descriptors (dvgl initialize_netvlad)")
    p.add_argument("--seed", type=int, default=42)
    return p


_CNN_BACKBONES = ("alexnet", "vgg16") + tuple(
    f"resnet{n}conv{c}" for n in (18, 50, 101) for c in (4, 5))


def parse(argv=None) -> argparse.Namespace:
    """The flags, with the cross-flag checks of dvgl parser.py:102-151 (the
    JAX CLI's messages)."""
    p = _parser()
    args = p.parse_args(argv)
    if args.queries_per_epoch % args.cache_refresh_every != 0:
        p.error(f"queries-per-epoch ({args.queries_per_epoch}) must be divisible "
                f"by cache-refresh-every ({args.cache_refresh_every})")
    if args.mining == "msls_weighted" and "msls" not in args.dataset.lower():
        p.error("msls_weighted mining can only be applied to the msls dataset")
    if args.backbone == "vit" and tuple(args.resize) not in ((224, 224), (384, 384)):
        p.error(f"Image size for ViT must be 224 or 384, got {args.resize}")
    if args.backbone == "cct384" and tuple(args.resize) != (384, 384):
        p.error(f"Image size for CCT384 must be 384, got {args.resize}")
    if args.backbone in _CNN_BACKBONES and args.aggregation in ("cls", "seqpool"):
        p.error(f"CNNs like {args.backbone} can't use aggregation {args.aggregation}")
    if args.backbone == "cct384" and args.aggregation in ("spoc", "mac", "rmac", "crn", "rrm"):
        p.error("CCT supports aggregations [netvlad, gem, cls, seqpool] only")
    if args.backbone == "vit" and args.aggregation not in ("cls", "gem", "netvlad"):
        p.error("ViT supports aggregations [netvlad, gem, cls] only")
    if args.trunc_te is not None and args.backbone not in ("cct384", "vit"):
        p.error("--trunc-te only applies to cct384 / vit backbones")
    if args.freeze_te is not None and args.backbone not in ("cct384", "vit"):
        p.error("--freeze-te only applies to cct384 / vit backbones")
    if args.remat and args.backbone != "vit":
        p.error("--remat only applies to the vit backbone")
    if args.netvlad_init_samples > 0 and args.aggregation == "netvlad" \
            and args.backbone not in _CNN_BACKBONES:
        # the JAX CLI grafts a CNN backbone out of the model for the k-means
        # (train_cli.py:169-210) and fails on a token backbone
        p.error("--netvlad-init-samples initializes NetVLAD over a CNN backbone only")
    if args.aggregation == "crn" and not args.resume:
        logging.warning("the reference requires CRN to resume from a trained NetVLAD "
                        "checkpoint (parser.py:118-119); training CRN from scratch")
    return args


def netvlad_init(model, variables, train_ds, n_samples: int, seed: int, dev) -> dict:
    """dvgl aggregation.py:148-174: a database sample through the backbone
    (the current parameters), its local descriptors L2-normalized,
    k-means of ``n_samples`` of them into the NetVLAD layer. The numpy
    draws are the JAX CLI's."""
    import numpy as np
    import torch

    from anyloc_tpu_torch.ops.common import l2_normalize
    from anyloc_tpu_torch.training.aggregators import NetVLAD

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in variables.items() if k.startswith(prefix)}

    sample_idx = np.random.default_rng(seed).choice(
        train_ds.database_num, min(max(n_samples // 64, 1), 16), replace=False)
    imgs = torch.from_numpy(np.stack([train_ds[i][0] for i in sample_idx])).to(dev)
    with torch.inference_mode():
        fmap = torch.func.functional_call(model.backbone, sub("backbone."), (imgs,))
        descs = l2_normalize(fmap.float()).reshape(-1, fmap.shape[-1]).cpu().numpy()
    rows = np.random.default_rng(seed).choice(len(descs), min(n_samples, len(descs)),
                                              replace=False)
    agg = NetVLAD.init_from_descriptors(sub("aggregation."), descs[rows], seed=seed)
    return {**variables, **{f"aggregation.{k}": v for k, v in agg.items()}}


def main(argv=None, device=None) -> int:
    """``device`` places the model, the steps, the mining and the
    evaluation (None: the card); it is for callers such as tests, not a
    flag."""
    args = parse(argv)

    import torch

    from anyloc_tpu_torch.data.registry import get_dataset
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.ops.common import resolve_device
    from anyloc_tpu_torch.training.network import GeoLocalizationNet, make_freeze_te_mask
    from anyloc_tpu_torch.training.train_loop import train_triplet
    from anyloc_tpu_torch.utils.logging_utils import setup_logging
    from anyloc_tpu_torch.utils.seeding import seed_everything

    dev = resolve_device(device)
    seed_everything(args.seed)
    setup_logging(args.output_dir)
    resize = tuple(args.resize)

    def load(name, split):
        try:
            return get_dataset(name, args.datasets_folder, split, img_size=resize)
        except (FileNotFoundError, OSError):
            return None

    train_ds = load(args.dataset, "train") or load(args.dataset, "test")
    if train_ds is None:
        raise FileNotFoundError(f"no train/test split for {args.dataset}")
    val_ds = load(args.val_dataset or args.dataset, "val")
    if val_ds is None:
        val_ds = train_ds
        logging.info("no val split; validating on the train dataset")

    model = materialize(lambda: GeoLocalizationNet(
        backbone=args.backbone, aggregation=args.aggregation,
        netvlad_clusters=args.netvlad_clusters, fc_output_dim=args.fc_output_dim,
        trunc_te=args.trunc_te, remat=args.remat, img_size=resize[0]), None, "cpu",
        seed=args.seed).to(dev)
    variables = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    if args.resume:
        from anyloc_tpu_torch.utils.checkpoint import resume_train

        state, start_epoch, best = resume_train(args.output_dir)
        variables = {k: v.to(dev) for k, v in state["params"].items()}
        logging.info(f"resumed at epoch {start_epoch} (best R@5 {best:.1f})")

    def descriptor_fn(params, images):
        return torch.func.functional_call(model, params, (images,))

    if args.netvlad_init_samples > 0 and args.aggregation == "netvlad":
        logging.info("k-means-initializing NetVLAD centroids")
        variables = netvlad_init(model, variables, train_ds, args.netvlad_init_samples,
                                 args.seed, dev)

    augment_fn = None
    if any((args.brightness, args.contrast, args.saturation, args.hue, args.horizontal_flip,
            args.random_resized_crop, args.rand_perspective, args.random_rotation)):
        from anyloc_tpu_torch.data.augment import make_augment_fn

        augment_fn = make_augment_fn(
            brightness=args.brightness, contrast=args.contrast, saturation=args.saturation,
            hue=args.hue, horizontal_flip=args.horizontal_flip,
            random_resized_crop=args.random_resized_crop,
            rand_perspective=args.rand_perspective, random_rotation=args.random_rotation)

    state, best_r5, history = train_triplet(
        descriptor_fn, variables, train_ds, val_ds,
        epochs=args.epochs, queries_per_epoch=args.queries_per_epoch,
        cache_refresh_every=args.cache_refresh_every,
        batch_size=args.train_batch_size, neg_num=args.neg_num,
        mining=args.mining, criterion=args.criterion, margin=args.margin,
        lr=args.lr, optim=args.optim, patience=args.patience,
        neg_samples_num=args.neg_samples_num,
        trainable_mask=(None if args.freeze_te is None
                        else make_freeze_te_mask(args.freeze_te)),
        output_dir=args.output_dir, recall_values=tuple(args.recall_values),
        eval_batch_size=args.infer_batch_size, test_method=args.test_method,
        efficient_ram=args.efficient_ram_testing, augment_fn=augment_fn, seed=args.seed,
        device=dev)
    logging.info(f"done: best R@5 {best_r5:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
