"""Quickstart: the AnyLoc-VLAD flow end to end on synthetic data (port of
examples/quickstart.py).

    python -m anyloc_tpu_torch.examples.quickstart [--cpu]

With real data, point --data-dir at your datasets root and pick a dataset
from ``anyloc_tpu_torch.dataset_names()``. Without it a synthetic gardens
tree (12 database and 6 query images of 126 px, ``data/synthetic.py``)
runs at layer <= 5 and VLAD <= 8. The weights are random (no downloads).
It runs on the card; ``--cpu`` runs it on the CPU.
"""

import argparse
import tempfile


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default=None, help="datasets root (default: synthetic)")
    p.add_argument("--dataset", default="gardens")
    p.add_argument("--model", default="dinov2_vits14")
    p.add_argument("--layer", type=int, default=11)
    p.add_argument("--clusters", type=int, default=32)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    from anyloc_tpu_torch.config import PipelineArgs
    from anyloc_tpu_torch.pipelines.vlad_pipeline import run_vlad_pipeline

    largs = PipelineArgs()
    with tempfile.TemporaryDirectory() as tmp:
        if args.data_dir is None:
            from anyloc_tpu_torch.data.synthetic import build_gardens

            args.data_dir = build_gardens(tmp, n_db=12, n_q=6, size=(126, 126))
            largs.bd_args.resize = (126, 126)
            largs.extractor.desc_layer = min(args.layer, 5)
            largs.vlad.num_clusters = min(args.clusters, 8)
            largs.extractor.batch_size = 4
            print(f"(no --data-dir: synthetic gardens at {args.data_dir})")
        else:
            largs.extractor.desc_layer = args.layer
            largs.vlad.num_clusters = args.clusters
        largs.prog.data_vg_dir = args.data_dir
        largs.prog.vg_dataset_name = args.dataset
        largs.extractor.model_type = args.model
        largs.top_k_vals = [1, 5, 10]
        results = run_vlad_pipeline(largs, device="cpu" if args.cpu else None)
    print({k: v for k, v in results.items() if k.startswith("R@")})
    return results


if __name__ == "__main__":
    main()
