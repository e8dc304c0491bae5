"""The flagship forward step, and one step of every sharded path on n ranks
(counterpart of the repository root's ``__graft_entry__.py``).

    python -m anyloc_tpu_torch.tools.dryrun [--world N] [--cpu]

``entry()`` returns the flagship step and its example inputs on the card:
DINOv2-G/14 in bfloat16, layer 31's value facet, VLAD-32, random weights
from seed 0. ``dryrun_multichip(n)`` runs each section of the JAX dryrun on
n ranks (``tools/mesh_checks.py``: one process per rank, Gloo where ranks
share a device, NCCL with a card each) at its tiny shapes and prints the
JAX dryrun's "... ok" lines, raising at the first section that fails:

  (a) the dp x tp triplet step of ViT-S/14 (4 blocks) + NetVLAD-4 with the
      Adam moments FSDP-sharded over ``data`` (12 steps, the loss falls;
      a rank's state below the replicated state), and the sharded
      checkpoint round trip (``dptrain``);
  (b) sharded k-means and sharded exact search (``kmeans``, ``search``);
  (c) the int8_full trunk with uint8 input and VLAD behind
      ``sharded_extract_fn`` (``dryserve``);
  (d)-(g), with a model axis (n >= 4 and even, as in the JAX dryrun): the
      tp_split trunk and its per-rank bytes (``tp``), the pipeline
      (``pp``), sequence parallelism (``sp``) and expert-parallel VLAD
      (``ep``), each against one rank;
  (h) the dp x pp training step against one process (``pptrain``, F25),
      dp x sp and dp x ep on the 2 x (n / 2) mesh;
  then exact search of a 32768 x 4096 database sharded over every rank
  with each rank's bytes, and the sharded PQ, IVF-PQ and IVF-flat engines
  (full probe equal to exact search) (``dryretrieval``).

``device`` None means the card; ``--cpu`` (``device="cpu"``) runs the ranks
on the CPU over Gloo.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Union

import numpy as np
import torch


def entry(device: Union[None, str, torch.device] = None):
    """(fn, example_args): the flagship forward step. ``fn(params, centers,
    images)`` -> [B, 32·1536] AnyLoc-VLAD-DINOv2 descriptors: the DINOv2-G/14
    trunk in bfloat16 (blocks 0..31 of ``params``, a state dict drawn from
    seed 0), layer 31's value facet without CLS, L2-normalized, VLAD-32.
    The inputs are 4 zero images of 224 px and zero centers, on ``device``
    (None: the card)."""
    from torch.func import functional_call

    from anyloc_tpu_torch.models.dinov2 import dinov2_config, init_params
    from anyloc_tpu_torch.models.vit import ViT
    from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device
    from anyloc_tpu_torch.ops.vlad import vlad_aggregate

    dev = resolve_device(device)
    cfg = dinov2_config("dinov2_vitg14", dtype=torch.bfloat16)
    layer, n_clusters = 31, 32
    params = init_params(cfg, seed=0, n_blocks=layer + 1, device=dev)
    with torch.device("meta"):
        model = ViT(cfg, layer + 1).eval()

    @torch.no_grad()
    def fn(params, centers, images):
        facet = functional_call(model, params, (images,),
                                {"capture_layer": layer, "capture_facet": "value"})
        return vlad_aggregate(l2_normalize(facet[:, 1:].float()), centers)

    images = torch.zeros((4, 224, 224, 3), dtype=torch.float32, device=dev)
    centers = torch.zeros((n_clusters, cfg.embed_dim), dtype=torch.float32, device=dev)
    return fn, (params, centers, images)


def _backend(dev: torch.device, n: int) -> str:
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def _close(got, want, atol: float, what: str) -> None:
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    if not err <= atol:
        raise AssertionError(f"{what}: {err:.3e} > {atol}")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device: Union[None, str, torch.device] = None,
                     emit=print) -> dict:
    """Every section of the JAX dryrun on ``n_devices`` ranks of ``device``
    (None: the card), printing its "... ok" lines (through ``emit``);
    raises at the first check that fails. Returns {case: {name: array}}."""
    from anyloc_tpu_torch.ops.common import resolve_device
    from anyloc_tpu_torch.tools import mesh_checks as mc

    dev = resolve_device(device)
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    cases = ["dptrain", "kmeans", "search", "dryserve", "dryretrieval"]
    if n_model > 1:
        cases += ["tp", "pp", "sp", "ep", "pptrain"]
    with tempfile.TemporaryDirectory(prefix="anyloc_dryrun_") as out:
        mc.launch(out, n_devices, _backend(dev, n_devices), str(dev), "small", cases,
                  timeout=1200)
        res = {c: mc.results(out, c) for c in cases}
    emit(f"mesh: {{'data': {n_devices // n_model}, 'model': {n_model}}} "
         f"({n_devices} ranks on {dev.type})")

    # (a) the dp x tp step, FSDP moments, the sharded checkpoint
    dp = res["dptrain"]
    losses = dp["losses"]
    fsdp_b, rep_b = float(dp["fsdp_bytes"]), float(dp["replicated_bytes"])
    _check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    _check(fsdp_b < rep_b, f"FSDP state {fsdp_b} >= replicated {rep_b}")
    _check(int(dp["sharded_moments"]) > 0, "no moment stayed data-sharded through 12 steps")
    emit(f"train 12 steps ok: loss {losses[0]:.4f} -> {losses[-1]:.4f}, state/device "
         f"{fsdp_b / 1e6:.1f} MB fsdp vs {rep_b / 1e6:.1f} MB replicated")
    lc, lr = dp["dptrain_resume_losses"]
    _check(lc == lr and not dp["dptrain_resume_diff"].any()
           and int(dp["dptrain_layout_mismatches"]) == 0, "the resumed step differs")
    emit(f"sharded checkpoint round-trip ok: bit-equal state after resumed step "
         f"{len(losses) + 1} (loss {lr:.4f})")

    # (b) sharded k-means and retrieval
    km = res["kmeans"]
    _close(km["cos_sharded"], km["cos_single"], 1e-4, "sharded k-means")
    emit(f"sharded kmeans ok: centers {tuple(km['cos_sharded'].shape)}")
    se = res["search"]
    _check((se["sep_f32_i"][:, 0] == np.arange(se["sep_f32_i"].shape[0])).all(),
           f"self-match {se['sep_f32_i'][:, 0]}")
    _check(np.array_equal(se["db512_cosine_i"], se["db512_cosine_single_i"]),
           "sharded ids differ from top_k_search")
    emit("sharded retrieval ok: self-match top-1 exact")

    # (c) the serving path
    sv = res["dryserve"]
    _check(sv["vlads"].shape == (2 * n_devices, 4 * 384), f"shape {sv['vlads'].shape}")
    _close(sv["vlads"], sv["single"], 1e-4, "sharded serving path")
    emit(f"sharded serving path ok: int8_full + uint8 + fused VLAD -> {sv['vlads'].shape}")

    if n_model > 1:
        # (d) tensor parallelism
        tp = res["tp"]
        _close(tp["tp"], tp["single"], 2e-4, "tp_split facets")
        shd_b, rep_b = float(tp["rank_bytes"]), float(tp["replicated_bytes"])
        n_tp = n_devices
        _check(shd_b < rep_b * (1.0 / n_tp + 0.35), f"tp bytes {shd_b} vs {rep_b}")
        emit(f"tp_split ok: facets equal; per-device params {shd_b / 1e6:.1f} MB vs replicated "
             f"{rep_b / 1e6:.1f} MB (n_model={n_tp})")
        # (e)-(g) pipeline, sequence and expert parallelism
        pp, sp = res["pp"], res["sp"]
        for key in ("5_value", "3_token", "2_query"):   # the same trunk and images
            _close(pp[key], pp[f"{key}_single"], 2e-4, f"pipeline {key}")
            _close(sp[key], pp[f"{key}_single"], 2e-4, f"sequence parallel {key}")
        _close(sp["extractor"], sp["extractor_single"], 2e-4, "SPFacetExtractor")
        coords = pp["coords"]
        n_stages = int(coords[:, 1].max()) + 1
        n_data = int(coords[:, 0].max()) + 1
        emit(f"pipeline parallel ok: facets equal over {n_stages} stages")
        emit(f"sequence parallel ok: ring-attention facets equal over {n_stages} token shards")
        ep = res["ep"]
        _check(bool(ep["ample_kept"].all()), "expert parallel dropped an image")
        _close(ep["ample_vlads"], ep["single"], 1e-4, "expert-parallel VLAD")
        n_exp = mc.inputs("ep", "small")["experts"].shape[0]
        emit(f"expert parallel ok: routed VLAD equal over {n_exp} experts / {n_stages} chips")
        # (h) stacked compositions
        pt = res["pptrain"]
        _check(abs(float(pt["loss"]) - float(pt["single_loss"])) < 1e-5, "dp x pp loss")
        for k in [k for k in pt if k.startswith("param.")]:
            _close(pt[k], pt["single_" + k], 2e-5, f"dp x pp {k}")
        _check(float(pt["rank_spread"]) == 0.0, "ranks' parameters differ after the step")
        emit(f"dp x pp training ok: loss {float(pt['loss']):.4f} and updated params equal "
             f"single-device (batch over data={n_data}, blocks over model={n_stages})")
        emit(f"dp x sp ok: facets equal with batch over data={n_data} x tokens over "
             f"model={n_stages}")
        emit(f"dp x ep ok: router-assigned VLAD equal direct (images over data={n_data}, "
             f"{n_exp} expert banks over model={n_stages})")

    # retrieval at a memory-scaled shape, and the compressed engines
    rt = res["dryretrieval"]
    big_b, shard_b = float(rt["big_bytes"]), rt["shard_bytes"].astype(np.float64)
    _check(shard_b.max() <= big_b // n_devices + 4096 * 4, f"shard bytes {shard_b}")
    _check(np.array_equal(rt["big_i"], rt["big_single_i"]), "sharded exact ids differ")
    _close(rt["big_s"], rt["big_single_s"], 1e-5, "sharded exact scores")
    emit(f"memory-scaled sharded retrieval ok: 32768x4096 ({big_b / 2**20:.0f} MB db, "
         f"{shard_b.max() / 2**20:.0f} MB/device on {n_devices} devices), top-5 ids equal "
         f"single-device exact")
    for name in ("pq", "ivf_pq", "ivf"):
        _check(np.array_equal(rt[f"{name}_i"], rt[f"{name}_single_i"]), f"sharded {name} ids")
        _close(rt[f"{name}_s"], rt[f"{name}_single_s"], 1e-5, f"sharded {name} scores")
    emit(f"sharded PQ retrieval ok: 16384x128 codes over {n_devices} devices "
         f"({float(rt['pq_codes_bytes']) // n_devices / 2**10:.0f} KB/device), top-5 equal "
         f"single-device ADC")
    emit(f"sharded IVF-PQ retrieval ok: 27 cells over {n_devices} devices (probe 9, overflow "
         f"pool of {int(rt['ipq_overflow'])} rows on shard 0), top-5 equal single-device")
    _check(np.array_equal(rt["ivf_i"], rt["exact_i"]), "IVF at full probe differs from exact")
    emit(f"sharded IVF-flat retrieval ok: 27 cells over {n_devices} devices, full probe "
         f"equals the exact engine")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=8, help="ranks (the JAX dryrun's devices)")
    p.add_argument("--cpu", action="store_true", help="run the ranks on the CPU (Gloo)")
    a = p.parse_args(argv)
    dryrun_multichip(a.world, "cpu" if a.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
