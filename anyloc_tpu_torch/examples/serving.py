"""Serving walkthrough: disk -> descriptors -> retrieval, with each
stage's time (port of examples/serving.py).

  1. native threaded JPEG decode straight to resized uint8
     (native/imagepipe.cpp), where it builds; else PIL (the host's decode
     path, not a kernel's);
  2. uint8 host->device transfer (1/4 the bytes of float32), normalized
     on the card;
  3. the int8_full DINOv2 trunk (each block is K4 then K3 on the card) ->
     the value facet;
  4. VLAD on the card in the same pass (K1): only the [B, C·D] global
     descriptors come home;
  5. exact top-k retrieval on the card.

    python -m anyloc_tpu_torch.examples.serving [--n-images 256] [--model dinov2_vitg14]

Defaults to a small trunk and synthetic JPEGs; the weights are random
(--checkpoint loads a DINOv2 state dict). It runs on the card; ``--cpu``
runs it on the CPU (the kernels' plain versions).
"""

import argparse
import os
import tempfile
import time

import numpy as np


def make_jpegs(root: str, n: int, size=(240, 320)) -> list:
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        img = (rng.random((size[0], size[1], 3)) * 255).astype(np.uint8)
        p = os.path.join(root, f"img_{i:05d}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=128)
    ap.add_argument("--model", default="dinov2_vits14")
    ap.add_argument("--layer", type=int, default=11)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--img-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--clusters", type=int, default=32)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    from anyloc_tpu_torch import VLAD, get_top_k_recall, native
    from anyloc_tpu_torch.data.base import VPRDataset
    from anyloc_tpu_torch.pipelines.engine import DescriptorEngine

    device = "cpu" if args.cpu else None
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = make_jpegs(root, args.n_images)
        print(f"[setup] {args.n_images} synthetic JPEGs in {time.perf_counter() - t0:.1f}s")

        ds = VPRDataset(paths, [], img_size=(args.img_size, args.img_size))
        engine = DescriptorEngine(args.model, args.layer, "value", checkpoint=args.checkpoint,
                                  batch_size=args.batch, quant="int8_full",
                                  transfer_dtype="uint8", device=device)
        print(f"[engine] {args.model} l{args.layer} value, int8_full trunk, uint8 transfer, "
              f"native decode={'yes' if native.imagepipe_available() else 'PIL fallback'}")

        def synced():
            if engine.extractor.device.type == "cuda":
                torch.cuda.synchronize()
            return time.perf_counter()

        # the vocabulary: descriptors kept on the device feed the k-means there
        t0 = synced()
        vocab = engine.extract_dataset(ds, which="db", sub_sample=4, verbose=False,
                                       keep_on_device=True)
        vlad = VLAD(num_clusters=args.clusters)
        vlad.fit(vocab.reshape(-1, vocab.shape[-1]))
        out["vocab_s"] = synced() - t0
        print(f"[vocab] fit VLAD-{args.clusters} on {vocab.shape[0]} images' descriptors "
              f"(device-resident) in {out['vocab_s']:.2f}s")

        # steady state: decode -> uint8 transfer -> int8 trunk -> VLAD, one
        # pass per batch; only [B, C·D] vectors come home
        engine.extract_vlads_dataset(ds, vlad, "db", verbose=False)   # warm
        t0 = synced()
        db_vlads = np.asarray(engine.extract_vlads_dataset(ds, vlad, "db", verbose=False))
        dt = synced() - t0
        out["serve_images_per_s"] = len(db_vlads) / dt
        print(f"[serve] {len(db_vlads)} images disk->VLAD descriptors (dim {db_vlads.shape[1]}) "
              f"in {dt:.2f}s  ({out['serve_images_per_s']:.1f} img/s end-to-end, one "
              f"{'CPU' if args.cpu else 'card'})")

        qu_vlads = db_vlads[: min(16, len(db_vlads))]
        gt = [np.array([i]) for i in range(len(qu_vlads))]
        t0 = time.perf_counter()
        _, idx, recalls = get_top_k_recall([1, 5], db_vlads, qu_vlads, gt, device=device)
        out["recalls"] = recalls
        print(f"[retrieve] top-5 over {len(db_vlads)} db in {time.perf_counter() - t0:.2f}s; "
              f"self-retrieval R@1={recalls[1]:.2f} (expect 1.0)")
        assert recalls[1] == 1.0
    return out


if __name__ == "__main__":
    main()
