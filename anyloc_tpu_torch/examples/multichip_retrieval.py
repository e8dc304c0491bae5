"""Multi-device example: sharded vocabulary k-means, database-sharded
retrieval (exact, PQ, IVF-PQ), expert-parallel routed VLAD and
sequence-parallel extraction over a mesh (port of
examples/multichip_retrieval.py).

    python -m anyloc_tpu_torch.examples.multichip_retrieval [--devices N] [--cpu]

The port runs one process per device (``parallel/``): ``--devices N``
ranks are started here (``tools/mesh_checks.launch``), on the card, or
on the CPU with ``--cpu``; ranks that share a device run Gloo, NCCL needs
a card each. Every rank makes the same calls on the same inputs (numpy
seed 0) and gets the same results; rank 0's are printed, with the JAX
example's lines. N must be even (the expert and sequence sections use a
(N / 2) x 2 mesh).
"""

import argparse
import tempfile

import numpy as np


def case_example(r) -> None:
    """The example's calls on one rank (``mesh_checks``' case)."""
    import torch

    from anyloc_tpu_torch.models.dinov2 import init_params
    from anyloc_tpu_torch.models.vit import ViTConfig
    from anyloc_tpu_torch.ops.ivf_pq import ivf_pq_fit, load_ivf_pq, save_ivf_pq
    from anyloc_tpu_torch.ops.pq import load_pq, pq_fit, save_pq
    from anyloc_tpu_torch.parallel import (SPFacetExtractor, ep_vlad_aggregate, get_mesh,
                                           ivf_pq_search_sharded, kmeans_fit_sharded,
                                           pq_search_sharded, route_by_domain,
                                           top_k_search_sharded)
    from anyloc_tpu_torch.parallel.mesh import barrier

    dev = r.device
    mesh = get_mesh(r.world, 1)
    rng = np.random.default_rng(0)
    # "patch descriptors" for the vocabulary: sharded k-means
    descs = rng.standard_normal((20_000, 256)).astype(np.float32)
    r.keep("centers", kmeans_fit_sharded(descs, 32, mesh, max_iters=25, device=dev))
    # database-sharded exact retrieval
    db = rng.standard_normal((50_000, 256)).astype(np.float32)
    rows = rng.choice(50_000, 100, replace=False)
    _, idx = top_k_search_sharded(db, db[rows], 10, mesh, device=dev)
    r.keep("exact_self", np.array(float(np.mean(np.asarray(idx)[:, 0] == rows))))
    # compressed retrieval: PQ codes and IVF-PQ cell buckets sharded the same way
    dbn = db / np.linalg.norm(db, axis=1, keepdims=True)
    sel = rng.choice(50_000, 64, replace=False)
    # one index for every rank: rank 0 fits it, the others read its file
    paths = (str(r.out / "pq.npz"), str(r.out / "ivf_pq.npz"))
    if r.rank == 0:
        save_pq(pq_fit(dbn, 32, method="cosine", device=dev), paths[0])
        save_ivf_pq(ivf_pq_fit(dbn, 64, m=32, method="cosine", device=dev), paths[1])
    barrier()
    pq_index = load_pq(paths[0], device=dev)
    _, i_pq = pq_search_sharded(pq_index, dbn[sel], 5, mesh, device=dev)
    ipq_index = load_ivf_pq(paths[1], device=dev)
    _, i_ipq = ivf_pq_search_sharded(ipq_index, dbn[sel], 5, mesh, n_probe=8, device=dev)
    r.keep("pq_mb", np.array(pq_index.codes.numel() / 2 ** 20))
    r.keep("db_mb", np.array(dbn.nbytes / 2 ** 20))
    r.keep("pq_self", np.array(float(np.mean(np.asarray(i_pq)[:, 0] == sel))))
    r.keep("ivf_pq_self", np.array(float(np.mean(np.asarray(i_ipq)[:, 0] == sel))))
    # expert parallelism: domain vocabularies over a 2-D mesh, images routed
    mesh2 = get_mesh(r.world // 2, 2)
    n_dom = 4
    experts = torch.from_numpy(rng.standard_normal((n_dom, 32, 256)).astype(np.float32)).to(dev)
    patch = torch.from_numpy(rng.standard_normal((r.world * 2, 49, 256)).astype(np.float32)
                             ).to(dev)
    domains = torch.from_numpy(rng.standard_normal((n_dom, 256)).astype(np.float32)).to(dev)
    vlads, kept = ep_vlad_aggregate(patch, route_by_domain(patch, domains), experts, mesh2,
                                    capacity_factor=float(n_dom))
    r.keep("ep_vlads", vlads)
    r.keep("ep_kept", kept)
    # sequence parallelism: ring-attention facet extraction
    cfg = ViTConfig(img_size=56, patch_size=14, embed_dim=96, depth=4, num_heads=4,
                    dtype=torch.float32)
    sp = SPFacetExtractor(cfg, init_params(cfg, seed=0, device=dev), 3, "value", mesh2,
                          device=dev)
    imgs = rng.standard_normal((r.world // 2 * 2, 56, 56, 3)).astype(np.float32)
    r.keep("sp_facets", sp(imgs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (Gloo)")
    args = ap.parse_args(argv)
    if args.devices < 2 or args.devices % 2:
        raise SystemExit("--devices must be even (a (N / 2) x 2 mesh)")

    import torch

    from anyloc_tpu_torch.ops.common import resolve_device
    from anyloc_tpu_torch.tools import mesh_checks

    dev = resolve_device("cpu" if args.cpu else None)
    backend = "nccl" if dev.type == "cuda" and torch.cuda.device_count() >= args.devices \
        else "gloo"
    case = f"{__name__}:case_example"
    with tempfile.TemporaryDirectory(prefix="multichip_") as out:
        mesh_checks.launch(out, args.devices, backend, str(dev), "small", [case], timeout=1200)
        res = mesh_checks.results(out, case)
    print(f"mesh: {{'data': {args.devices}}} over {args.devices} ranks ({backend}, {dev.type})")
    print(f"vocabulary: {res['centers'].shape} (Lloyd sums all-reduced over the mesh)")
    print("retrieval: top-10 over 50k sharded db; exact self-match rate "
          f"{float(res['exact_self']):.2f}")
    print(f"sharded PQ/IVF-PQ: {float(res['pq_mb']):.1f} MB of codes vs "
          f"{float(res['db_mb']):.0f} MB f32, sharded 1/{args.devices} per rank; self top-1 "
          f"pq {float(res['pq_self']):.2f} / ivf_pq {float(res['ivf_pq_self']):.2f}")
    print(f"expert-parallel VLAD: {tuple(res['ep_vlads'].shape)} (routed over 4 domain "
          f"vocabularies, kept={int(res['ep_kept'].sum())})")
    print(f"sequence-parallel facets: {tuple(res['sp_facets'].shape)} (tokens ring-sharded "
          f"over 2 ranks)")
    return res


if __name__ == "__main__":
    main()
