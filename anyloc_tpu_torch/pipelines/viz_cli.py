"""Cluster-visualization app (counterpart of
``anyloc_tpu/pipelines/viz_cli.py``) — CLI replacement for the reference's gradio /
HF-space demos (demo/gradio_imgs_vlad_clusters.py, hf_imgs_vlad_clusters.py):
per-pixel VLAD cluster-assignment overlays + the GeM t-SNE domain projector,
written as image/JSON artifacts instead of a web UI (gradio isn't in this
image; the functions compose into a gradio app unchanged where it exists).

Usage:
  python -m anyloc_tpu_torch viz clusters --in-dir imgs/ \
      --cache-dir cache/ --domain indoor --out-dir viz/
  python -m anyloc_tpu_torch viz domain --in-dir imgs/ \
      --gem-cache gem_descs.npz --out viz/domain.json

The extractor runs on the card (``main(argv, device=...)`` places it
elsewhere, for callers such as tests); ``domain``, ``radar`` and a report
with ``--gem-cache`` need scikit-learn / matplotlib.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def cmd_clusters(args, device=None) -> int:
    from PIL import Image

    from anyloc_tpu_torch.data.base import natsorted
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.pipelines.demo import vocab_dir
    from anyloc_tpu_torch.viz import cluster_assignment_map

    vdir = vocab_dir(args.cache_dir, args.model, args.layer, args.facet,
                     args.num_clusters, args.domain)
    vlad = VLAD(args.num_clusters, cache_dir=vdir)
    vlad.fit(None)
    ext = DinoV2ExtractFeatures(args.model, args.layer, args.facet, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    paths = natsorted(
        [p for e in ("*.jpg", "*.png") for p in glob.glob(os.path.join(args.in_dir, e))]
    )
    patch = ext.cfg.patch_size
    for path in paths[: args.first_n] if args.first_n else paths:
        pil = Image.open(path).convert("RGB")
        arr = preprocess_image(pil, max_edge=args.max_img_size, crop_multiple=patch)
        descs = ext(arr[None])[0]
        gh, gw = arr.shape[0] // patch, arr.shape[1] // patch
        raw = np.asarray(pil.resize((arr.shape[1], arr.shape[0])))
        overlay = cluster_assignment_map(
            descs, vlad.c_centers, (gh, gw), image=raw,
            alpha=args.alpha, device=ext.device,
        )
        out = os.path.join(args.out_dir,
                           os.path.splitext(os.path.basename(path))[0] + "_clusters.png")
        Image.fromarray(overlay).save(out)
        print(out)
    return 0


def cmd_domain(args, device=None) -> int:
    """Project user images against cached per-dataset GeM descriptors
    (hf_imgs_vlad_clusters.py:257-356 domain projector)."""
    from PIL import Image

    from anyloc_tpu_torch.data.base import natsorted
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
    from anyloc_tpu_torch.ops.gem import gem_pool
    from anyloc_tpu_torch.viz import tsne_projection

    ref = dict(np.load(args.gem_cache))  # {dataset_name: [N, D]}
    ext = DinoV2ExtractFeatures(args.model, args.layer, args.facet, device=device)
    user = []
    paths = natsorted(glob.glob(os.path.join(args.in_dir, "*.jpg")))
    for path in paths:
        arr = preprocess_image(Image.open(path).convert("RGB"),
                               size_hw=(224, 224), crop_multiple=14)
        d = ext(arr[None])
        user.append(gem_pool(d).cpu().numpy()[0])
    ref["user"] = np.stack(user)
    proj = tsne_projection(ref)
    out = {k: v.tolist() for k, v in proj.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(args.out)
    return 0


def cmd_report(args, device=None) -> int:
    """One self-contained interactive HTML — the app artifact the reference's
    gradio / HF-space demos produce (alpha blending, cluster toggles,
    patch-pick, domain t-SNE), dependency-free in any browser."""
    from PIL import Image

    from anyloc_tpu_torch.data.base import natsorted
    from anyloc_tpu_torch.data.registry import DOMAIN_RECIPES
    from anyloc_tpu_torch.data.transforms import preprocess_image
    from anyloc_tpu_torch.models.extractor import DinoV2ExtractFeatures
    from anyloc_tpu_torch.ops.gem import gem_pool
    from anyloc_tpu_torch.ops.kmeans import assign_labels
    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.pipelines.demo import vocab_dir
    from anyloc_tpu_torch.pipelines.report_html import build_report
    from anyloc_tpu_torch.viz import _CLUSTER_COLORS, tsne_projection

    vdir = vocab_dir(args.cache_dir, args.model, args.layer, args.facet,
                     args.num_clusters, args.domain)
    vlad = VLAD(args.num_clusters, cache_dir=vdir)
    vlad.fit(None)
    ext = DinoV2ExtractFeatures(args.model, args.layer, args.facet, device=device)
    centers = vlad.c_centers.to(ext.device)
    patch = ext.cfg.patch_size
    paths = natsorted(
        [p for e in ("*.jpg", "*.jpeg", "*.png")
         for p in glob.glob(os.path.join(args.in_dir, e))]
    )
    if args.first_n:
        paths = paths[: args.first_n]
    images, gems = [], []
    for path in paths:
        pil = Image.open(path).convert("RGB")
        arr = preprocess_image(pil, max_edge=args.max_img_size,
                               crop_multiple=patch)
        descs = ext(arr[None])[0]
        gh, gw = arr.shape[0] // patch, arr.shape[1] // patch
        images.append({
            "name": os.path.basename(path),
            "rgb": np.asarray(pil.resize((arr.shape[1], arr.shape[0]))),
            "grid": (gh, gw),
            "labels": assign_labels(descs, centers).cpu().numpy(),
        })
        if args.gem_cache:
            gems.append(gem_pool(descs[None]).cpu().numpy()[0])

    domain_points = None
    if args.gem_cache:
        ref = dict(np.load(args.gem_cache))  # {dataset_name: [N, D]}
        ds_domain = {}
        for dom in ("indoor", "urban", "aerial"):
            for name in DOMAIN_RECIPES.get(dom, {}):
                ds_domain[name] = dom
        ref["user"] = np.stack(gems)
        proj = tsne_projection(ref)
        domain_points = []
        for name, pts in proj.items():
            for j, (x, y) in enumerate(np.asarray(pts)):
                if name == "user":
                    domain_points.append({
                        "name": images[j]["name"], "domain": "user",
                        "x": float(x), "y": float(y), "user": True,
                    })
                else:
                    domain_points.append({
                        "name": name,
                        "domain": ds_domain.get(name, "other"),
                        "x": float(x), "y": float(y),
                    })
    pal = _CLUSTER_COLORS[
        np.arange(args.num_clusters) % len(_CLUSTER_COLORS)
    ]
    html = build_report(
        images, pal, domain_points,
        config_line=(
            f"{args.model} layer {args.layer} {args.facet} facet · "
            f"VLAD-{args.num_clusters} · domain vocabulary: {args.domain}"
        ),
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(html)
    print(args.out)
    if args.serve:
        import functools
        import http.server

        d = os.path.dirname(os.path.abspath(args.out))
        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=d
        )
        with http.server.ThreadingHTTPServer(("", args.serve), handler) as s:
            print(f"serving {d} at http://localhost:{args.serve}/"
                  f"{os.path.basename(args.out)} (Ctrl-C to stop)")
            s.serve_forever()
    return 0


def cmd_radar(args, device=None) -> int:
    """paper_utils/radar_chart.py surface: the paper's published per-domain
    R@1 aggregates (viz.PAPER_RADAR_R1), optionally merged with the user's
    own method rows from a JSON file {"name": [8 values]}."""
    from anyloc_tpu_torch.viz import PAPER_RADAR_R1, radar_chart

    data = dict(PAPER_RADAR_R1)
    if args.extra:
        import json

        with open(args.extra) as f:
            data.update(json.load(f))
    out = radar_chart(data, output_path=args.out)
    print(out)
    return 0


def main(argv=None, device=None) -> int:
    """``device`` places the extractor (None: the card); it is for callers
    such as tests, not a flag."""
    p = argparse.ArgumentParser(prog="python -m anyloc_tpu_torch viz", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("report", help="one interactive self-contained HTML "
                       "(the gradio/HF-space demo artifact)")
    r.add_argument("--in-dir", required=True)
    r.add_argument("--out", required=True, help="output .html path")
    r.add_argument("--cache-dir", default="./cache")
    r.add_argument("--domain", default="indoor")
    r.add_argument("--model", default="dinov2_vitg14")
    r.add_argument("--layer", type=int, default=31)
    r.add_argument("--facet", default="value")
    r.add_argument("--num-clusters", type=int, default=32)
    r.add_argument("--max-img-size", type=int, default=640)
    r.add_argument("--first-n", type=int, default=None)
    r.add_argument("--gem-cache", default=None,
                   help="npz of per-dataset GeM descriptors -> adds the "
                        "domain-projection section")
    r.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the report over stdlib http.server")
    c = sub.add_parser("clusters")
    c.add_argument("--in-dir", required=True)
    c.add_argument("--out-dir", required=True)
    c.add_argument("--cache-dir", default="./cache")
    c.add_argument("--domain", default="indoor")
    c.add_argument("--model", default="dinov2_vitg14")
    c.add_argument("--layer", type=int, default=31)
    c.add_argument("--facet", default="value")
    c.add_argument("--num-clusters", type=int, default=32)
    c.add_argument("--max-img-size", type=int, default=640)
    c.add_argument("--alpha", type=float, default=0.5)
    c.add_argument("--first-n", type=int, default=None)
    d = sub.add_parser("domain")
    d.add_argument("--in-dir", required=True)
    d.add_argument("--gem-cache", required=True)
    d.add_argument("--out", required=True)
    d.add_argument("--model", default="dinov2_vitg14")
    d.add_argument("--layer", type=int, default=31)
    d.add_argument("--facet", default="value")
    ra = sub.add_parser("radar", help="paper radar chart "
                        "(published per-domain R@1 aggregates)")
    ra.add_argument("--out", default="radar_chart.png")
    ra.add_argument("--extra", default=None,
                    help="JSON of extra method rows {name: [8 R@1 values]}")
    args = p.parse_args(argv)
    return {"clusters": cmd_clusters, "domain": cmd_domain,
            "report": cmd_report, "radar": cmd_radar}[args.cmd](args, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
