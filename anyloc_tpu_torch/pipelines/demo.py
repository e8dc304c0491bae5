"""End-user demo (counterpart of ``anyloc_tpu/pipelines/demo.py``; the
reference's ``demo/anyloc_vlad_generate.py``): load a cached domain
vocabulary, extract DINOv2 facets of a directory of images (longest edge
capped, center-cropped to the patch grid), aggregate them with VLAD on
the device, write one ``.npy`` per image.

The vocabulary cache layout is the reference's
(demo/anyloc_vlad_generate.py:140-145):
``<cache>/vocabulary/<model>/l<layer>_<facet>_c<clusters>/<domain>/c_centers.*``,
``.npz`` or a reference-exported ``.pt``.

    python -m anyloc_tpu_torch demo --in-dir IMAGES --cache-dir CACHE \\
        [--domain indoor|aerial|urban|auto] [--quant int8_full]

It runs on the card; ``main(argv, device="cpu")`` runs the plain path on
the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from anyloc_tpu_torch.data.base import natsorted


def vocab_dir(cache_dir: str, model: str, layer: int, facet: str,
              n_clusters: int, domain: str) -> str:
    return os.path.join(cache_dir, "vocabulary", model, f"l{layer}_{facet}_c{n_clusters}",
                        domain)


def processed_shape(w: int, h: int, max_edge: int, multiple: int = 14):
    """``preprocess_image``'s output (H, W) from the source size alone (PIL
    reads it from the header without decoding): the key that buckets
    same-shape images into one batched trunk call."""
    if max(w, h) > max_edge:
        scale = max_edge / max(w, h)
        w, h = int(round(w * scale)), int(round(h * scale))
    return (h // multiple) * multiple, (w // multiple) * multiple


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--in-dir", required=True, help="directory of images")
    p.add_argument("--out-dir", default=None, help="output dir (default: in-dir)")
    p.add_argument("--domain", default="indoor", choices=["aerial", "indoor", "urban", "auto"],
                   help="'auto' routes each image to the GeM-nearest domain among every "
                        "cached vocabulary; requires <vocab-root>/gem_centroids.npz (build it "
                        "once with pipelines.demo.build_gem_centroids)")
    p.add_argument("--cache-dir", default="./cache")
    p.add_argument("--model", default="dinov2_vitg14")
    p.add_argument("--layer", type=int, default=31)
    p.add_argument("--facet", default="value")
    p.add_argument("--num-clusters", type=int, default=32)
    p.add_argument("--max-img-size", type=int, default=1024)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--quant", default=None, choices=["int8", "int8_fused", "int8_full"],
                   help="int8 trunk mode")
    p.add_argument("--first-n", type=int, default=None)
    p.add_argument("--batch", type=int, default=0,
                   help="images per trunk call: same-shape images bucket into one batched "
                        "call. 0 = auto per bucket by token count (~4096 token rows a "
                        "call, at most 16 images; one image at 1022 px)")
    return p


def _load_domains(args, device):
    """--domain auto: every cached domain vocabulary under the vocabulary
    root, and the GeM centroids that route between them."""
    import torch

    from anyloc_tpu_torch.ops.vlad import VLAD

    root = os.path.dirname(vocab_dir(args.cache_dir, args.model, args.layer, args.facet,
                                     args.num_clusters, "x"))
    domains = sorted(d for d in (os.listdir(root) if os.path.isdir(root) else [])
                     if glob.glob(os.path.join(root, d, "c_centers.*")))
    if not domains:
        raise FileNotFoundError(f"no cached domain vocabularies in {root}")
    vlads = {}
    for d in domains:
        v = VLAD(args.num_clusters, cache_dir=os.path.join(root, d))
        v.fit(None)
        vlads[d] = v
    cents_path = os.path.join(root, "gem_centroids.npz")
    if not os.path.exists(cents_path):
        # routing compares GeM image descriptors; VLAD centers are another
        # statistic (signed, near-zero mean), so there is no fallback
        raise FileNotFoundError(
            f"--domain auto needs {cents_path}; build it once from "
            "representative map images with "
            "anyloc_tpu_torch.pipelines.demo.build_gem_centroids")
    z = np.load(cents_path)
    stale = [d for d in domains if d not in z.files]
    if stale:
        raise KeyError(f"gem_centroids.npz has no centroid for cached domain(s) "
                       f"{stale}; rebuild it with build_gem_centroids")
    centroids = np.stack([z[d] for d in domains])
    dim = next(iter(vlads.values())).desc_dim
    if dim is not None and centroids.shape[1] != dim:
        raise ValueError(f"gem_centroids dim {centroids.shape[1]} != the vocabulary's "
                         f"descriptor dim {dim}: built with a different trunk?")
    print(f"auto-domain over {domains}; centroids: {cents_path}")
    return domains, vlads, torch.from_numpy(centroids.astype(np.float32)).to(device)


def main(argv=None, device=None) -> int:
    """``device`` places the trunk and the aggregation (None: the card); it
    is for callers such as tests, not a flag."""
    args = _parser().parse_args(argv)

    import torch
    from PIL import Image

    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
    from anyloc_tpu_torch.ops.common import resolve_device
    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.parallel.ep import route_by_domain

    device = resolve_device(device)
    if args.domain == "auto":
        domains, vlads, centroids = _load_domains(args, device)
    else:
        vdir = vocab_dir(args.cache_dir, args.model, args.layer, args.facet,
                         args.num_clusters, args.domain)
        vlad = VLAD(args.num_clusters, cache_dir=vdir)
        vlad.fit(None)   # load only: raises without a cached vocabulary
        print(f"Loaded vocabulary: {vdir}")

    extractor = DinoV2ExtractFeatures(args.model, args.layer, args.facet,
                                      checkpoint=args.checkpoint, quant=args.quant,
                                      device=device)
    out_dir = args.out_dir or args.in_dir
    os.makedirs(out_dir, exist_ok=True)
    paths = natsorted([p for ext in ("*.jpg", "*.jpeg", "*.png")
                       for p in glob.glob(os.path.join(args.in_dir, ext))])
    if args.first_n:
        paths = paths[:args.first_n]
    print(f"{len(paths)} images")

    # same-shape images (predicted from the header, no decode) run as one
    # batched trunk call
    buckets: dict = {}
    for path in paths:
        with Image.open(path) as im:
            w, h = im.size
        shape = processed_shape(w, h, args.max_img_size)
        if shape[0] < 14 or shape[1] < 14:
            print(f"{os.path.basename(path)}: skipped — {h}x{w} px preprocesses to "
                  f"{shape[0]}x{shape[1]} (< one 14-px patch; extreme aspect ratio or "
                  f"tiny source)")
            continue
        buckets.setdefault(shape, []).append(path)

    for shape, bpaths in buckets.items():
        if args.batch > 0:
            bsz = args.batch
        else:
            # ~4k token rows a call: a 1022-px image (5.3k tokens) alone
            tokens = max(1, (shape[0] // 14) * (shape[1] // 14))
            bsz = max(1, min(16, round(4096 / tokens)))
        for i in range(0, len(bpaths), bsz):
            chunk = bpaths[i:i + bsz]
            arrs = np.stack([preprocess_image(Image.open(p).convert("RGB"),
                                              max_edge=args.max_img_size, crop_multiple=14)
                             for p in chunk])
            descs = extractor(arrs)
            picked = [""] * len(chunk)
            if args.domain == "auto":
                routes = route_by_domain(descs, centroids).cpu().numpy()
                gds = np.empty((len(chunk), args.num_clusters * descs.shape[-1]), np.float32)
                for d_idx in np.unique(routes):
                    sel = np.nonzero(routes == d_idx)[0]
                    dname = domains[int(d_idx)]
                    rows = torch.from_numpy(sel).to(descs.device)
                    gds[sel] = vlads[dname].aggregate(descs[rows]).cpu().numpy()
                    for s in sel:
                        picked[int(s)] = f" [{dname}]"
            else:
                # aggregated on the device: only the C·D global descriptors
                # come home, not the [B, N, D] facets
                gds = vlad.aggregate(descs).cpu().numpy()
            for j, path in enumerate(chunk):
                out = os.path.join(out_dir, os.path.splitext(os.path.basename(path))[0] + ".npy")
                np.save(out, gds[j])
                print(f"{os.path.basename(path)} -> {out} ({gds[j].shape[0]}-dim){picked[j]}")
    return 0


def build_gem_centroids(extractor, domain_images, out_path: str, max_edge: int = 448) -> dict:
    """Write ``gem_centroids.npz`` for ``--domain auto``: per domain, the
    mean GeM (|d|^p) descriptor of representative (map) images, through
    ``extractor`` on its device. ``domain_images``: {domain: [paths]}.
    Returns {domain: [D]}."""
    from PIL import Image

    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.ops.gem import gem_pool

    cents = {}
    for domain, paths in domain_images.items():
        gems = []
        for path in paths:
            arr = preprocess_image(Image.open(path).convert("RGB"), max_edge=max_edge,
                                   crop_multiple=14)
            gems.append(gem_pool(extractor(arr[None]), use_abs=True).cpu().numpy()[0])
        cents[domain] = np.mean(gems, axis=0)
    np.savez(out_path, **cents)
    return cents


if __name__ == "__main__":
    raise SystemExit(main())
