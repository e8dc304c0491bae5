"""Command line of the PyTorch port: ``python -m anyloc_tpu_torch <pipeline> [--args...]``.

The counterpart of ``python -m anyloc_tpu``, over the same PipelineArgs
flags; it runs on the CUDA card.

  global-vocab-vlad   SOTA AnyLoc-VLAD with a domain vocabulary
                      (--global-vocab indoor, or --db-samples NAME=FREQ ...)
  vlad                per-dataset-vocabulary VLAD

Datasets come from the registry under --prog.data-vg-dir (the reference's
layouts, e.g. 17places as ref/ query/ ground_truth_new.npy); the results
JSON (no per-query rows) goes to <--prog.cache-dir>/experiments/<--exp-id>/.

Serving fast path flags:
  --extractor.quant int8_full --extractor.transfer-dtype uint8

Not ported yet (each raises, naming its ROADMAP.md port-queue item):
gem, global-vpr, gp, clip-top-k, patch-clip, demo, serve, sweep
("The other pipelines"), train, eval ("Training"), viz ("Tooling").
"""

from __future__ import annotations

import json
import os
import sys

from anyloc_tpu_torch.config import PipelineArgs, parse_args

# subcommands of the JAX package's CLI that the port has not reached, by
# the title of their ROADMAP.md port-queue item
NOT_PORTED = {
    "gem": "The other pipelines", "global-vpr": "The other pipelines",
    "gp": "The other pipelines", "clip-top-k": "The other pipelines",
    "patch-clip": "The other pipelines", "demo": "The other pipelines",
    "serve": "The other pipelines", "sweep": "The other pipelines",
    "train": "Training", "eval": "Training", "viz": "Tooling",
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
    if cmd == "global-vocab-vlad":
        from anyloc_tpu_torch.pipelines.global_vocab_vlad import run_global_vocab_vlad as fn
    elif cmd == "vlad":
        from anyloc_tpu_torch.pipelines.vlad_pipeline import run_vlad_pipeline as fn
    else:
        print(f"Unknown pipeline: {cmd}", file=sys.stderr)
        return 2
    largs = parse_args(PipelineArgs, rest)
    results = fn(largs, device=device)
    _save(results, largs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
