"""Ablation sweeps (counterpart of ``anyloc_tpu/sweeps.py``; the
reference's scripts/*_ablations.sh): one product sweep over the grid that
reuses one engine across the grid points that share a trunk, and writes a
tidy CSV.

  python -m anyloc_tpu_torch sweep --pipeline vlad \\
      --prog.data-vg-dir /data/vpr \\
      --grid.model-type dinov2_vits14 dinov2_vitb14 \\
      --grid.desc-layer 9 11 --grid.desc-facet key value \\
      --grid.num-clusters 8 32 --grid.dataset gardens baidu_datasets \\
      --out sweep_results.csv

A failing grid point is caught and recorded as a row with ``error`` (the
reference's try/except pattern), so a sweep runs to its end. ``--plot``
then draws the ablation figure from the CSV (``viz.ablation_plot``,
matplotlib).
"""

from __future__ import annotations

import argparse
import copy
import csv
import itertools
import os
import sys
import traceback
from typing import Dict, List, Optional

from anyloc_tpu_torch.config import PipelineArgs


def run_sweep(pipeline: str, grid: Dict[str, List], base: Optional[PipelineArgs] = None,
              out_csv: Optional[str] = None, verbose: bool = True, device=None) -> List[Dict]:
    """grid keys: model_type, desc_layer, desc_facet, num_clusters, dataset,
    domain (any subset; the others come from ``base``). The engine is
    rebuilt only when (model_type, desc_layer, desc_facet, quant,
    transfer_dtype) changes. ``device`` places the engines (None: the
    card)."""
    from anyloc_tpu_torch.pipelines.engine import DescriptorEngine
    from anyloc_tpu_torch.pipelines.gem_pipeline import run_gem_pipeline
    from anyloc_tpu_torch.pipelines.global_vocab_vlad import run_global_vocab_vlad
    from anyloc_tpu_torch.pipelines.vlad_pipeline import run_vlad_pipeline
    from anyloc_tpu_torch.utils.logging_utils import MetricsLogger, run_name_for

    fn = {"vlad": run_vlad_pipeline, "global-vocab-vlad": run_global_vocab_vlad,
          "gem": run_gem_pipeline}[pipeline]
    base = base or PipelineArgs()
    keys = list(grid)
    rows: List[Dict] = []
    engine_key, engine = None, None
    for values in itertools.product(*(grid[k] for k in keys)):
        point = dict(zip(keys, values))
        largs = copy.deepcopy(base)
        if "model_type" in point:
            largs.extractor.model_type = point["model_type"]
        if "desc_layer" in point:
            largs.extractor.desc_layer = int(point["desc_layer"])
        if "desc_facet" in point:
            largs.extractor.desc_facet = point["desc_facet"]
        if "num_clusters" in point:
            largs.vlad.num_clusters = int(point["num_clusters"])
        if "dataset" in point:
            largs.prog.vg_dataset_name = point["dataset"]
        if "domain" in point:
            largs.global_vocab = point["domain"]
        if largs.vlad.cache_dir:
            # one vocabulary cache per grid point: a shared one would make
            # every later point reuse the first point's centers
            tag = "_".join(f"{k}-{v}" for k, v in point.items())
            largs.vlad.cache_dir = os.path.join(largs.vlad.cache_dir, tag)
        ek = (largs.extractor.model_type, largs.extractor.desc_layer,
              largs.extractor.desc_facet, largs.extractor.quant, largs.extractor.transfer_dtype)
        try:
            if ek != engine_key:
                e = largs.extractor
                engine = DescriptorEngine(e.model_type, e.desc_layer, e.desc_facet, e.checkpoint,
                                          e.dtype, e.batch_size, quant=e.quant,
                                          transfer_dtype=e.transfer_dtype, device=device)
                engine_key = ek
            results = fn(largs, engine=engine, verbose=False)
            row = dict(point)
            row.update({k: v for k, v in results.items() if not k.startswith("Qual-")})
            # the reference's run naming: the group is the domain (or the
            # dataset), the name encodes the configuration, so the CSV lines
            # up with the reference's exported ablation tables
            group = point.get("domain", largs.prog.vg_dataset_name)
            run_name = run_name_for(
                pipeline, largs.extractor.model_type, layer=largs.extractor.desc_layer,
                facet=largs.extractor.desc_facet, clusters=largs.vlad.num_clusters,
                dataset=largs.prog.vg_dataset_name, domain=point.get("domain"))
            row["wandb_group"], row["run_name"] = group, run_name
            if largs.prog.use_wandb:
                ml = MetricsLogger(use_wandb=True, project=largs.prog.wandb_proj,
                                   entity=largs.prog.wandb_entity, group=group,
                                   run_name=run_name, config=point)
                for k in sorted(int(c[2:]) for c in results if c.startswith("R@")):
                    ml.log({"Recall": results[f"R@{k}"]}, step=k)
                ml.finish()
            rows.append(row)
            if verbose:
                r1 = results.get("R@1")
                print(f"{point} -> R@1={'n/a' if r1 is None else f'{r1:.4f}'}")
        except Exception:
            traceback.print_exc()
            rows.append(dict(point, error=True))
    if out_csv and rows:
        fieldnames = sorted({k for r in rows for k in r})
        os.makedirs(os.path.dirname(os.path.abspath(out_csv)), exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(rows)
    return rows


# the reference's published ablation grids (scripts/*_ablations.sh and
# paper_utils/data/ablations); combine with --grid.dataset
PRESETS = {
    # facet ordering (facet/dinov2_*.csv: value > token >> query > key)
    "facets": {"model_type": ["dinov2_vitg14"], "desc_layer": [31],
               "desc_facet": ["query", "key", "value", "token"], "num_clusters": [32]},
    # layer ablation per model (vit_and_layer/*.csv)
    "layers-g14": {"model_type": ["dinov2_vitg14"], "desc_facet": ["value"],
                   "desc_layer": list(range(39, -1, -1)), "num_clusters": [32]},
    "layers-l14": {"model_type": ["dinov2_vitl14"], "desc_facet": ["value"],
                   "desc_layer": list(range(23, -1, -1)), "num_clusters": [32]},
    "layers-b14": {"model_type": ["dinov2_vitb14"], "desc_facet": ["value"],
                   "desc_layer": list(range(11, -1, -1)), "num_clusters": [32]},
    "layers-s14": {"model_type": ["dinov2_vits14"], "desc_facet": ["value"],
                   "desc_layer": list(range(11, -1, -1)), "num_clusters": [32]},
    # vocabulary size
    "clusters": {"model_type": ["dinov2_vitg14"], "desc_layer": [31],
                 "desc_facet": ["value"], "num_clusters": [256, 128, 64, 32]},
    # domain vocabularies (global-vocab pipeline)
    "domains": {"model_type": ["dinov2_vitg14"], "desc_layer": [31],
                "desc_facet": ["value"], "num_clusters": [32],
                "domain": ["indoor", "urban", "aerial", "structured", "unstructured", "both"]},
}


def main(argv=None, device=None) -> int:
    """``device`` places the engines (None: the card); it is for callers
    such as tests, not a flag."""
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pipeline", default="vlad", choices=["vlad", "global-vocab-vlad", "gem"])
    p.add_argument("--out", default="sweep_results.csv")
    p.add_argument("--grid.model-type", dest="g_model", nargs="*", default=[])
    p.add_argument("--grid.desc-layer", dest="g_layer", nargs="*", type=int, default=[])
    p.add_argument("--grid.desc-facet", dest="g_facet", nargs="*", default=[])
    p.add_argument("--grid.num-clusters", dest="g_clusters", nargs="*", type=int, default=[])
    p.add_argument("--grid.dataset", dest="g_dataset", nargs="*", default=[])
    p.add_argument("--grid.domain", dest="g_domain", nargs="*", default=[])
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="start from a published ablation grid; explicit --grid.* values "
                        "override its entries")
    p.add_argument("--plot", nargs="?", const="auto", default=None, metavar="X_COL",
                   help="after the sweep, regenerate a paper_utils-style ablation figure "
                        "from the CSV (one command: sweep -> CSV -> figure). Value = the "
                        "swept column for the x-axis; bare --plot picks the grid axis with "
                        "the most values. Output: <out>.png")
    args, rest = p.parse_known_args(argv)
    from anyloc_tpu_torch.config import parse_args

    base = parse_args(PipelineArgs, rest)
    grid = dict(PRESETS[args.preset]) if args.preset else {}
    for key, vals in (("model_type", args.g_model), ("desc_layer", args.g_layer),
                      ("desc_facet", args.g_facet), ("num_clusters", args.g_clusters),
                      ("dataset", args.g_dataset), ("domain", args.g_domain)):
        if vals:
            grid[key] = vals
    run_sweep(args.pipeline, grid, base, args.out, device=device)
    if args.plot:
        x_col = args.plot
        if x_col == "auto":
            multi = [k for k in grid if len(grid[k]) > 1] or list(grid)
            x_col = max(multi, key=lambda k: len(grid[k]))
        from anyloc_tpu_torch.viz import ablation_plot

        png = os.path.splitext(args.out)[0] + ".png"
        ablation_plot({args.pipeline: args.out}, x_col=x_col, output_path=png,
                      title=f"{args.pipeline} ablation: R@1 vs {x_col}")
        print(f"figure: {png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
