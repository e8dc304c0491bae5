"""Command line of the PyTorch port: ``python -m anyloc_tpu_torch <pipeline> [--args...]``.

The counterpart of ``python -m anyloc_tpu``, over the same PipelineArgs
flags; it runs on the CUDA card.

  global-vocab-vlad   SOTA AnyLoc-VLAD with a domain vocabulary
                      (--global-vocab indoor, or --db-samples NAME=FREQ ...)
  vlad                per-dataset-vocabulary VLAD
  gem                 GeM pooling
  global-vpr          CLS-token global descriptor
  gp                  global max pooling
  clip-top-k          CLIP global-descriptor retrieval
  patch-clip          CLIP crops -> VLAD
  demo                a directory of images -> one VLAD .npy each
                      (the reference's demo/anyloc_vlad_generate.py)
  serve               HTTP daemon: /describe + /search over a loaded
                      vocabulary and database
  sweep               ablation grids (the reference's *_ablations.sh)
  eval                a trained baseline (dvgl GeoLocalizationNet, MixVPR,
                      CosPlace) on a dataset: --model-family dvgl | mixvpr |
                      cosplace, --checkpoint .pth / .ckpt (dvgl's eval.py)
  train               dvgl triplet training of a GeoLocalizationNet
                      (dvgl's train.py flags: --backbone, --aggregation,
                      --mining, --epochs, --resume, ...)

Datasets come from the registry under --prog.data-vg-dir (the reference's
layouts, e.g. 17places as ref/ query/ ground_truth_new.npy); the results
JSON (no per-query rows) goes to <--prog.cache-dir>/experiments/<--exp-id>/.

Serving fast path flags (vlad / global-vocab-vlad / gem / gp):
  --extractor.quant int8_full --extractor.transfer-dtype uint8

Not ported yet (raises, naming its ROADMAP.md port-queue item):
viz ("Tooling").
"""

from __future__ import annotations

import json
import os
import sys

from anyloc_tpu_torch.config import PipelineArgs, parse_args

# subcommands of the JAX package's CLI that the port has not reached, by
# the title of their ROADMAP.md port-queue item
NOT_PORTED = {"viz": "Tooling"}
# subcommands with their own argument parsers
OWN_PARSERS = {
    "demo": "anyloc_tpu_torch.pipelines.demo",
    "serve": "anyloc_tpu_torch.pipelines.serve_http",
    "sweep": "anyloc_tpu_torch.sweeps",
    "eval": "anyloc_tpu_torch.training.eval_cli",
    "train": "anyloc_tpu_torch.training.train_cli",
}


def _save(results, largs: PipelineArgs):
    if not largs.save_results:
        return
    out_dir = os.path.join(largs.prog.cache_dir, "experiments",
                           str(largs.exp_id or "default"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"results_{results['Timestamp']}.json")
    clean = {k: v for k, v in results.items() if not k.startswith("Qual-")}
    with open(path, "w") as f:
        json.dump(clean, f, indent=2, default=str)
    print(f"Saved results: {path}")


def main(argv=None, device=None) -> int:
    """``device`` places the pipeline (None: the card); it is for callers
    such as tests, not a flag."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd in NOT_PORTED:
        raise NotImplementedError(
            f"the {cmd!r} subcommand is not ported yet (ROADMAP.md, port "
            f'queue: "{NOT_PORTED[cmd]}")')
    if cmd in OWN_PARSERS:
        import importlib

        return importlib.import_module(OWN_PARSERS[cmd]).main(rest, device=device)
    if cmd == "global-vocab-vlad":
        from anyloc_tpu_torch.pipelines.global_vocab_vlad import run_global_vocab_vlad as fn
    elif cmd == "vlad":
        from anyloc_tpu_torch.pipelines.vlad_pipeline import run_vlad_pipeline as fn
    elif cmd == "gem":
        from anyloc_tpu_torch.pipelines.gem_pipeline import run_gem_pipeline as fn
    elif cmd == "global-vpr":
        from anyloc_tpu_torch.pipelines.global_vpr import run_global_vpr as fn
    elif cmd == "gp":
        from anyloc_tpu_torch.pipelines.gp_pipeline import run_gp_pipeline as fn
    elif cmd == "clip-top-k":
        from anyloc_tpu_torch.pipelines.clip_pipelines import run_clip_top_k as fn
    elif cmd == "patch-clip":
        from anyloc_tpu_torch.pipelines.clip_pipelines import run_patch_clip as fn
    else:
        print(f"Unknown pipeline: {cmd}", file=sys.stderr)
        return 2
    largs = parse_args(PipelineArgs, rest)
    results = fn(largs, device=device)
    _save(results, largs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
