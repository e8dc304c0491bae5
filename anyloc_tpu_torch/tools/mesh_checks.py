"""The multi-rank paths of ``parallel/`` run across a group of processes,
each case against its single-device path.

    python -m anyloc_tpu_torch.tools.mesh_checks --world 2 --backend gloo \\
        --device cuda --out DIR [--profile full] [CASE ...]

``launch`` starts ``world`` ranks with the ``spawn`` start method (a
parent that has touched CUDA cannot fork), joins them to one group over a
``file://`` store in ``out``, and runs the cases (``CASES``) on every rank.
Rank 0 writes each case's arrays to ``out/<case>__<name>.npy``; every rank
writes ``out/rank<r>.json`` with each case's seconds and the kernel
launches of its sharded calls alone (``Rank.sharded``: rank 0's
single-device references are not counted). A launch past its ``timeout``
kills the group and raises.

Profiles: "small" (a ViT of width 128, 4 heads, float32, databases of
hundreds of rows: the CPU tests hold it against the JAX package, which
they feed from ``inputs`` and the files they put under ``out/given``) and
"full" (DINOv2-G/14 width in bfloat16 and int8_full on a card, the trunk
cut to a few blocks so that the Gloo traffic stays small; each case's
single-device path runs on rank 0 beside it). Ranks that share one card
run a Gloo group (``parallel/mesh.py``). The training cases
(``CASES_TRAIN``: the collectives under autograd, FSDP, data x model
training, sync BatchNorm, tensor-parallel training, the sharded restore)
run when named; "small" holds them against the JAX package on the CPU,
"full" runs dvgl's vit + NetVLAD-64 and resnet18conv4 at their published
widths on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# (layers, image px, batch) of the trunk cases per profile
TRUNK = {"small": dict(img=56, batch=4, depth=6),
         "full": dict(img=224, batch=8, depth=4)}
SP_PX = {"small": 56, "full": 1022}
CASES_SMALL = ("kmeans", "search", "compressed", "extract", "tp", "pp", "sp", "ep", "serve")
CASES_FULL = ("extract", "tp", "pp", "sp", "ep", "kmeans", "search")
# the training cases (CASES_TRAIN below) run when named


# ---------------------------------------------------------------------------
# inputs (numpy seeds; the CPU tests call the same functions)
# ---------------------------------------------------------------------------

def vit_config(profile: str, **kw):
    """The trunk of the trunk cases: width 128 / 4 heads of 32 (a head dim
    the card's attention kernels take) / SwiGLU, float32 ("small"), or
    DINOv2-G/14 in bfloat16 ("full"), LayerScale 0.5 so that every block
    moves the tokens."""
    from anyloc_tpu_torch.models.dinov2 import dinov2_config
    from anyloc_tpu_torch.models.vit import ViTConfig

    if profile == "small":
        cfg = ViTConfig(img_size=56, patch_size=14, embed_dim=128, depth=TRUNK["small"]["depth"],
                        num_heads=4, mlp_type="swiglu_fused", layerscale_init=0.5,
                        dtype=torch.float32)
    else:
        cfg = dataclasses.replace(dinov2_config("dinov2_vitg14", dtype=torch.bfloat16),
                                  depth=TRUNK["full"]["depth"], layerscale_init=0.5)
    return dataclasses.replace(cfg, **kw)


def vit_params(cfg, seed: int = 0, device="cpu") -> dict:
    """The trunk's state dict (DINOv2 naming): ``dinov2.init_params`` on
    ``device`` from ``seed``, the same on every rank."""
    from anyloc_tpu_torch.models.dinov2 import init_params

    return init_params(dataclasses.replace(cfg, quant=None), seed, device=device)


def images(profile: str, px: int, batch: int, seed: int = 1) -> np.ndarray:
    """[B, px, px, 3] normalized float32 images."""
    return np.random.default_rng(seed).standard_normal((batch, px, px, 3)).astype(np.float32)


def inputs(case: str, profile: str) -> dict:
    """The numpy inputs of ``case``."""
    rng = np.random.default_rng({"kmeans": 0, "search": 2, "ep": 3, "sp": 4}[case])
    if case == "kmeans":
        if profile == "small":
            return {"cos": rng.standard_normal((1000, 16)).astype(np.float32),
                    "euc": rng.standard_normal((1003, 8)).astype(np.float32)}
        return {"cos": rng.standard_normal((50_000, 1536)).astype(np.float32)}
    if case == "search":
        if profile == "small":
            centers = rng.standard_normal((64, 32)).astype(np.float32) * 5.0
            return {"db509": rng.standard_normal((509, 24)).astype(np.float32),
                    "db512": rng.standard_normal((512, 24)).astype(np.float32),
                    "qu": rng.standard_normal((13, 24)).astype(np.float32),
                    "sep_db": centers + 0.01 * rng.standard_normal((64, 32)).astype(np.float32),
                    "sep_qu": centers[:8]}
        db = rng.standard_normal((20_000, 1536)).astype(np.float32)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        return {"db": db, "qu": db[rng.choice(20_000, 256, replace=False)]}
    if case == "ep":
        e, c, d, b, t = (8, 4, 16, 16, 9) if profile == "small" else (4, 32, 1536, 8, 256)
        route = rng.integers(0, e, b).astype(np.int32)
        oor = route.copy()
        oor[3], oor[7] = e, -1
        return {"experts": rng.standard_normal((e, c, d)).astype(np.float32),
                "descs": rng.standard_normal((b, t, d)).astype(np.float32),
                "route": route, "route_oor": oor}
    if case == "sp":
        return {name: rng.standard_normal((2, 3, 16, 4)).astype(np.float32)
                for name in ("q", "k", "v")}
    raise KeyError(case)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rank:
    rank: int
    world: int
    device: torch.device
    profile: str
    out: Path
    arrays: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def sharded(self):
        """Add the kernel launches made inside to ``launches``: around the
        sharded calls, never around a single-device reference."""
        from anyloc_tpu_torch.ops import kernels as K

        before = K.launch_counts()
        try:
            yield
        finally:
            for name, n in K.launch_counts().items():
                if n > before[name]:
                    self.launches[name] = self.launches.get(name, 0) + n - before[name]

    def keep(self, name: str, value) -> None:
        """One result array (rank 0 writes it), copied as it is now."""
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy() if value.is_floating_point() \
                else value.cpu().numpy()
        self.arrays[name] = np.array(value, copy=True)

    def given(self, name: str):
        """A file the caller put under ``out/given`` (None if absent)."""
        path = self.out / "given" / name
        if not path.exists():
            return None
        return np.load(path, allow_pickle=False) if path.suffix == ".npy" else path


def _sync(r: Rank) -> None:
    if r.device.type == "cuda":
        torch.cuda.synchronize()


def case_kmeans(r: Rank) -> None:
    from anyloc_tpu_torch.ops.kmeans import draw_rows, kmeans_fit
    from anyloc_tpu_torch.parallel import get_mesh, kmeans_fit_sharded

    mesh = get_mesh(r.world, 1)
    setups = {"cos": (8, "cosine", 20), "euc": (4, "euclidean", 15)} if r.profile == "small" \
        else {"cos": (32, "cosine", 10)}
    for tag, x in inputs("kmeans", r.profile).items():
        c, mode, iters = setups[tag]
        rows = r.given(f"kmeans_{tag}_init.npy")
        if rows is None:
            rows = draw_rows(x.shape[0], c, torch.Generator().manual_seed(0))
        with r.sharded():
            got = kmeans_fit_sharded(x, c, mesh, mode, iters, init_rows=rows, device=r.device)
        r.keep(f"{tag}_sharded", got)
        if r.rank == 0:
            xd = torch.from_numpy(x).to(r.device)
            r.keep(f"{tag}_single", kmeans_fit(xd, c, mode, iters, init_centers=xd[rows])[0])


def case_search(r: Rank) -> None:
    from anyloc_tpu_torch.ops.retrieval import top_k_search
    from anyloc_tpu_torch.parallel import get_mesh, top_k_search_sharded
    from anyloc_tpu_torch.parallel.mesh import pad_to_multiple, shard_rows

    mesh = get_mesh(r.world, 1)
    inp = inputs("search", r.profile)
    runs = []
    if r.profile == "small":
        for n in (509, 512):
            for method in ("cosine", "l2"):
                runs.append((f"db{n}_{method}", inp[f"db{n}"], inp["qu"], 7, method, "float32"))
        runs.append(("sep_bf16", inp["sep_db"], inp["sep_qu"], 3, "cosine", "bfloat16"))
        runs.append(("sep_f32", inp["sep_db"], inp["sep_qu"], 3, "cosine", "float32"))
        small = inp["db512"][:10] / np.linalg.norm(inp["db512"][:10], axis=1, keepdims=True)
        runs.append(("clamp", small, small[:2], 14, "cosine", "float32"))
    else:
        runs += [("f32", inp["db"], inp["qu"], 20, "cosine", "float32"),
                 ("bf16", inp["db"], inp["qu"], 20, "cosine", "bfloat16")]
    for name, db, qu, k, method, sd in runs:
        with r.sharded():
            s, i = top_k_search_sharded(db, qu, k, mesh, method, score_dtype=sd, device=r.device)
        r.keep(f"{name}_s", s)
        r.keep(f"{name}_i", i)
        if r.rank == 0:
            dbd, qud = (torch.from_numpy(np.ascontiguousarray(a)).to(r.device) for a in (db, qu))
            s1, i1 = top_k_search(dbd, qud, min(k, db.shape[0]), method, score_dtype=sd)
            r.keep(f"{name}_single_s", s1)
            r.keep(f"{name}_single_i", i1)
    # a resident, pre-padded shard with the valid row count
    db = runs[0][1]
    padded, nv = pad_to_multiple(db, r.world)
    local = torch.from_numpy(np.ascontiguousarray(shard_rows(padded, mesh))).to(r.device)
    with r.sharded():
        s, i = top_k_search_sharded(local, runs[0][2], runs[0][3], mesh, runs[0][4], n_valid=nv)
    r.keep("resident_s", s)
    r.keep("resident_i", i)


def case_compressed(r: Rank) -> None:
    """The compressed engines on the indexes the caller gives
    (``given/compressed.json``: name, kind, k, n_probe, scan; the index
    ``<name>.npz`` and queries ``<name>_qu.npy``); the recall wrapper on
    the entries of kind "recall_<engine>" (``<name>_db.npy``,
    ``<name>_gt.npy``)."""
    from anyloc_tpu_torch.ops.ivf import load_ivf
    from anyloc_tpu_torch.ops.ivf_pq import load_ivf_pq
    from anyloc_tpu_torch.ops.pq import load_pq
    from anyloc_tpu_torch.parallel import distributed as D
    from anyloc_tpu_torch.parallel import get_mesh

    manifest = r.given("compressed.json")
    if manifest is None:
        return
    mesh = get_mesh(r.world, 1)
    loaders = {"pq": load_pq, "ivf": load_ivf, "ivf_pq": load_ivf_pq}
    for e in json.loads(Path(manifest).read_text()):
        name, kind = e["name"], e["kind"]
        qu = r.given(f"{name}_qu.npy")
        if kind.startswith("recall_"):
            engine = kind[len("recall_"):]
            index = None if engine == "device" else loaders[engine](
                str(r.out / "given" / f"{name}.npz"), device=r.device)
            gt = [np.array([g]) for g in r.given(f"{name}_gt.npy")]
            db = r.given(f"{name}_db.npy")
            with r.sharded():
                d, i, rec = D.get_top_k_recall_sharded(
                    [1, 5], db, qu, gt, mesh, method=e.get("method", "cosine"),
                    norm_descs=e.get("norm", True), engine=engine, n_probe=e.get("n_probe", 8),
                    index=index, device=r.device)
            r.keep(f"{name}_s", d)
            r.keep(f"{name}_i", i)
            r.keep(f"{name}_recall", np.array([rec[1], rec[5]], np.float64))
            continue
        index = loaders[kind](str(r.out / "given" / f"{name}.npz"), device=r.device)
        with r.sharded():
            if kind == "pq":
                s, i = D.pq_search_sharded(index, qu, e["k"], mesh, scan=e.get("scan", "auto"),
                                           device=r.device)
            elif kind == "ivf":
                s, i = D.ivf_search_sharded(index, qu, e["k"], mesh, n_probe=e["n_probe"],
                                            device=r.device)
            else:
                s, i = D.ivf_pq_search_sharded(index, qu, e["k"], mesh, n_probe=e["n_probe"],
                                               device=r.device)
        r.keep(f"{name}_s", s)
        r.keep(f"{name}_i", i)


def _extractor(cfg, params, layer: int, device):
    from anyloc_tpu_torch.models.extractor import ViTFacetExtractor
    from anyloc_tpu_torch.ops.quant import quantize_vit_params

    if cfg.quant:
        params = quantize_vit_params(params, cfg.quant, min_size=1)
    return ViTFacetExtractor(cfg, params, layer, "value", device=device)


def case_extract(r: Rank) -> None:
    """``sharded_extract_fn``, and ``DescriptorEngine(mesh=...)``: patches,
    fused VLAD, ``extract_batch`` and the descriptor cache (rank 0 writes,
    the others read), against the engine on one rank."""
    from PIL import Image

    from anyloc_tpu_torch.data.base import VPRDataset
    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.parallel import get_mesh, sharded_extract_fn
    from anyloc_tpu_torch.parallel.mesh import barrier
    from anyloc_tpu_torch.pipelines.engine import DescriptorEngine

    mesh = get_mesh(r.world, 1)
    if r.profile == "small":
        rng = np.random.default_rng(5)
        w = torch.from_numpy(rng.standard_normal((12, 6)).astype(np.float32)).to(r.device)
        run = sharded_extract_fn(lambda p, x: torch.tanh(torch.from_numpy(x).to(r.device) @ p),
                                 mesh)
        with r.sharded():
            r.keep("toy", run(w, rng.standard_normal((21, 12)).astype(np.float32)))
    t = TRUNK[r.profile]
    px, n_img = t["img"], 10 if r.profile == "small" else t["batch"]
    root = r.out / "extract_images"
    if r.rank == 0:
        root.mkdir(exist_ok=True)
        rng = np.random.default_rng(6)
        for j in range(n_img):
            Image.fromarray((rng.random((px, px, 3)) * 255).astype(np.uint8)).save(
                root / f"i{j}.png")
    barrier()
    ds = VPRDataset([str(root / f"i{j}.png") for j in range(n_img)], [], img_size=(px, px))
    modes = [(None, "float32")] if r.profile == "small" else [(None, "uint8"),
                                                               ("int8_full", "uint8")]
    layer = t["depth"] - 1
    params = vit_params(vit_config(r.profile), 0, r.device)
    for quant, transfer in modes:
        tag = quant or str(vit_config(r.profile).dtype).removeprefix("torch.")
        ext = _extractor(vit_config(r.profile, quant=quant), params, layer, r.device)
        vlad = VLAD(4 if r.profile == "small" else 32)
        centers = r.given("extract_centers.npy")
        if centers is None:
            g = torch.Generator().manual_seed(7)
            centers = torch.randn((vlad.num_clusters, ext.cfg.embed_dim), generator=g).numpy()
        vlad.c_centers = torch.from_numpy(np.asarray(centers, np.float32)).to(r.device)
        kw = dict(extractor=ext, batch_size=4, transfer_dtype=transfer)
        eng = DescriptorEngine(mesh=mesh, cache_dir=str(r.out / f"cache_{tag}"), **kw)
        batch = np.stack([np.asarray(Image.open(root / f"i{j}.png"), np.float32) / 255.0
                          for j in range(3)])
        with r.sharded():
            t0 = time.perf_counter()
            r.keep(f"{tag}_vlads", eng.extract_vlads_dataset(ds, vlad, "db", verbose=False))
            _sync(r)
            r.keep(f"{tag}_seconds", np.array(time.perf_counter() - t0))
            r.keep(f"{tag}_descs", eng.extract_dataset(ds, "db", verbose=False))
            r.keep(f"{tag}_cached", eng.extract_vlads_dataset(ds, vlad, "db", verbose=False))
            r.keep(f"{tag}_batch", eng.extract_batch(batch))
        if r.rank == 0:
            one = DescriptorEngine(**kw)
            t0 = time.perf_counter()
            r.keep(f"{tag}_single_vlads", one.extract_vlads_dataset(ds, vlad, "db",
                                                                   verbose=False))
            _sync(r)
            r.keep(f"{tag}_single_seconds", np.array(time.perf_counter() - t0))
            r.keep(f"{tag}_single_descs", one.extract_dataset(ds, "db", verbose=False))
            r.keep(f"{tag}_single_batch", one.extract_batch(batch))
        barrier()


def case_tp(r: Rank) -> None:
    """A ``tp_split`` trunk sharded over ``model`` = world against the
    fused trunk on one rank; the bytes a rank holds against the
    replicated trunk's."""
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel.tp import (params_bytes_per_device, shard_vit_tp,
                                              split_fused_params)

    mesh = get_mesh(1, r.world)
    t = TRUNK[r.profile]
    layer = 1 if r.profile == "small" else t["depth"] - 1
    params = vit_params(vit_config(r.profile), 0, r.device)
    img = images(r.profile, t["img"], 2 if r.profile == "small" else t["batch"])
    split = _extractor(vit_config(r.profile, tp_split=True), split_fused_params(params), layer,
                       r.device)
    r.keep("replicated_bytes", np.array(params_bytes_per_device(split.model)))
    shard_vit_tp(split.model, mesh)
    r.keep("rank_bytes", np.array(params_bytes_per_device(split.model)))
    with r.sharded():
        r.keep("tp", split(img))
    if r.rank == 0:
        r.keep("single", _extractor(vit_config(r.profile), params, layer, r.device)(img))
        if r.profile == "full":   # the bf16 trunk's own distance from float32
            r.keep("single_f32", _extractor(vit_config(r.profile, dtype=torch.float32), params,
                                            layer, r.device)(img))


def _pp_sp_mesh(r: Rank):
    from anyloc_tpu_torch.parallel import get_mesh

    return get_mesh(2, r.world // 2) if r.world >= 4 else get_mesh(1, r.world)


def _facets(r: Rank):
    if r.profile == "small":
        return ((5, "value"), (3, "token"), (2, "query"))
    return ((TRUNK["full"]["depth"] - 1, "value"),)


def case_pp(r: Rank) -> None:
    """GPipe over ``model``: facets against the trunk run in sequence, and
    a pre-staged run with the bytes of this rank's stage."""
    from anyloc_tpu_torch.models.dinov2 import build_vit
    from anyloc_tpu_torch.parallel import pipeline_facet_extract, stack_stage_params
    from anyloc_tpu_torch.parallel.pp import pipeline_params_bytes_per_device, stage_params

    from anyloc_tpu_torch.parallel.mesh import all_gather, axis_index, axis_size

    mesh = _pp_sp_mesh(r)
    # every rank's (data, model) coordinates, in rank order
    r.keep("coords", all_gather(torch.tensor([[axis_index(mesh, "data"),
                                               axis_index(mesh, "model")]]), mesh, None))
    cfg = vit_config(r.profile)
    t = TRUNK[r.profile]
    params = vit_params(cfg, 0, r.device)
    img = images(r.profile, t["img"], t["batch"])
    for layer, facet in _facets(r):
        with r.sharded():
            r.keep(f"{layer}_{facet}", pipeline_facet_extract(cfg, params, img, mesh, layer,
                                                              facet, device=r.device))
        if r.rank == 0:
            with torch.inference_mode():
                trunk = build_vit(cfg, params, layer + 1, device=r.device)
                r.keep(f"{layer}_{facet}_single", trunk(
                    torch.from_numpy(img).to(r.device), capture_layer=layer,
                    capture_facet=facet))
    layer = _facets(r)[0][0]
    n_stages = axis_size(mesh, "model")
    stacked = stack_stage_params(params, layer, n_stages)
    staged = stage_params(stacked, mesh)
    with r.sharded():
        r.keep("staged", pipeline_facet_extract(cfg, params, img, mesh, layer, "value",
                                                stacked=staged, device=r.device))
    r.keep("stage_bytes", np.array(pipeline_params_bytes_per_device(staged)))
    r.keep("stacked_bytes", np.array(pipeline_params_bytes_per_device(stacked)))


def case_sp(r: Rank) -> None:
    """Ring attention against dense attention; sequence-parallel facets and
    ``SPFacetExtractor`` against the trunk on one rank."""
    from anyloc_tpu_torch.models.extractor import ViTFacetExtractor
    from anyloc_tpu_torch.parallel import (SPFacetExtractor, get_mesh, ring_attention,
                                           sp_facet_extract)
    from anyloc_tpu_torch.parallel.mesh import shard_rows

    if r.profile == "small":
        ring_mesh = get_mesh(1, r.world)
        inp = inputs("sp", "small")
        t_real = 11
        loc = {n: shard_rows(torch.from_numpy(a).transpose(0, 2), ring_mesh, "model")
               .transpose(0, 2).to(r.device) for n, a in inp.items()}
        mask = shard_rows(torch.arange(16) < t_real, ring_mesh, "model").to(r.device)
        with r.sharded():
            got = ring_attention(loc["q"], loc["k"], loc["v"], mask, axis_name="model",
                                 n_shards=r.world, mesh=ring_mesh)
        from anyloc_tpu_torch.parallel.mesh import all_gather

        r.keep("ring", all_gather(got.transpose(0, 2).contiguous(), ring_mesh, "model")
               .transpose(0, 2))
    mesh = _pp_sp_mesh(r)
    cfg = vit_config(r.profile)
    px = SP_PX[r.profile]
    params = vit_params(cfg, 0, r.device)
    img = images(r.profile, px, 4 if r.profile == "small" else 1)
    layer = 3
    sp = SPFacetExtractor(cfg, params, layer, "value", mesh, device=r.device)
    u8 = (np.random.default_rng(8).random(img.shape) * 255).astype(np.uint8)
    with r.sharded():
        for layer_f, facet in _facets(r):
            r.keep(f"{layer_f}_{facet}", sp_facet_extract(cfg, params, img, mesh, layer_f, facet,
                                                          device=r.device))
        r.keep("extractor", sp(img))
        r.keep("extractor_u8", sp(u8))
    if r.rank == 0:
        ref = ViTFacetExtractor(cfg, params, layer, "value", device=r.device)
        r.keep("extractor_single", ref(img))
        r.keep("extractor_u8_single", ref(u8))


def case_ep(r: Rank) -> None:
    """Routed VLAD with the experts sharded over ``model``: ample and tight
    capacity, out-of-range routes, the shape errors; against
    ``vlad_aggregate`` with each image's expert."""
    from anyloc_tpu_torch.ops.vlad import vlad_aggregate
    from anyloc_tpu_torch.parallel import ep_vlad_aggregate

    mesh = _pp_sp_mesh(r)
    inp = {k: torch.from_numpy(v).to(r.device) for k, v in inputs("ep", r.profile).items()}
    runs = [("ample", "route", 8.0)]
    if r.profile == "small":
        runs += [("tight", "route", 0.7), ("oor", "route_oor", 8.0)]
    for name, route, cap in runs:
        with r.sharded():
            v, kept = ep_vlad_aggregate(inp["descs"], inp[route], inp["experts"], mesh,
                                        capacity_factor=cap)
        r.keep(f"{name}_vlads", v)
        r.keep(f"{name}_kept", kept)
    if r.profile == "small":
        errors = []
        # experts that do not divide the expert axis; a batch that does not
        # divide the mesh (odd counts: every mesh here is even)
        for args in ((inp["descs"], inp["route"], inp["experts"][:5]),
                     (inp["descs"][:9], inp["route"][:9], inp["experts"])):
            try:
                ep_vlad_aggregate(*args, mesh)
                errors.append(False)
            except ValueError:
                errors.append(True)
        r.keep("errors", np.array(errors))
    if r.rank == 0:
        d, e, route = inp["descs"], inp["experts"], inp["route"].long()
        r.keep("single", torch.cat([vlad_aggregate(d[i:i + 1], e[route[i]])
                                    for i in range(d.shape[0])]))


def case_serve(r: Rank) -> None:
    """``serve --mesh world`` (exact, ``--pq``, ``--ivf``) against the
    daemon in one process, on the same vocabulary, database and images."""
    import argparse
    import io
    import threading
    import urllib.request

    from PIL import Image

    from anyloc_tpu_torch.ops.vlad import VLAD
    from anyloc_tpu_torch.parallel.mesh import barrier
    from anyloc_tpu_torch.pipelines import serve_http

    work = r.out / "serve"
    if r.rank == 0:
        work.mkdir(exist_ok=True)
        rng = np.random.default_rng(9)
        VLAD(4, cache_dir=str(work / "vocab")).fit(
            rng.standard_normal((120, 384)).astype(np.float32))
        np.save(work / "db.npy", rng.standard_normal((300, 4 * 384)).astype(np.float32))
    barrier()
    pngs = []
    rng = np.random.default_rng(10)
    for _ in range(3):
        buf = io.BytesIO()
        Image.fromarray((rng.random((70, 84, 3)) * 255).astype(np.uint8)).save(buf, "PNG")
        pngs.append(buf.getvalue())

    def args(**kw):
        a = dict(model="dinov2_vits14", layer=2, facet="value", num_clusters=4,
                 vocab_dir=str(work / "vocab"), checkpoint=None, quant=None, max_img_size=84,
                 img_size=0, db=str(work / "db.npy"), ivf=False, pq=False, pq_m=64, n_probe=4,
                 mesh=0, host="127.0.0.1", port=0, max_batch=16, batch_window_ms=5.0,
                 transfer_dtype="float32", warm=True)
        a.update(kw)
        return argparse.Namespace(**a)

    def replies(server, engine):
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            out = []
            for png in pngs:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/search?k=5", data=png,
                                             method="POST")
                with urllib.request.urlopen(req, timeout=120) as f:
                    out.append(json.loads(f.read()))
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as f:
                health = json.loads(f.read())
            return out, health
        finally:
            server.shutdown()
            server.server_close()

    for engine, kw in (("device", {}), ("pq", dict(pq=True, pq_m=8)), ("ivf", dict(ivf=True))):
        with r.sharded():
            server = serve_http.build_server(args(mesh=r.world, **kw), device=r.device)
            if r.rank != 0:
                server.serve_forever()   # the follow loop, until rank 0 closes
                continue
            got, health = replies(server, engine)
        want, _ = replies(serve_http.build_server(args(**kw), device=r.device), engine)
        r.keep(f"{engine}_ids", np.array([g["ids"] for g in got]))
        r.keep(f"{engine}_scores", np.array([g["scores"] for g in got]))
        r.keep(f"{engine}_single_ids", np.array([w["ids"] for w in want]))
        r.keep(f"{engine}_single_scores", np.array([w["scores"] for w in want]))
        r.keep(f"{engine}_engine", np.array(health["engine"]))


# ---------------------------------------------------------------------------
# the training half: FSDP, data x model training, sync BatchNorm, TP training
# ---------------------------------------------------------------------------

# dvgl's vit + NetVLAD per profile: ViT-B/16 (cut to ``trunc`` blocks in
# "small"), image px, clusters, tuples of 1 + 1 + neg images
DVGL = {"small": dict(px=32, trunc=2, clusters=4, tuples=4, neg=2),
        "full": dict(px=224, trunc=None, clusters=64, tuples=4, neg=10)}
# resnet18conv4 + NetVLAD under sync BatchNorm: (H, W), images, clusters
SYNCBN = {"small": dict(hw=(32, 48), batch=8, clusters=4),
          "full": dict(hw=(480, 640), batch=4, clusters=64)}
CASES_TRAIN = ("collectives", "fsdp", "dptrain", "syncbn", "tptrain", "restore")


def _given_state(r: Rank, name: str):
    """A state dict the caller saved under ``out/given`` (torch.save), on
    the CPU, or None."""
    path = r.out / "given" / name
    return torch.load(path, map_location="cpu") if path.exists() else None


def dvgl_vit(r: Rank, tp_split: bool = False):
    """dvgl's vit + NetVLAD (``DVGL``): the weights the caller gave
    (``given/dvgl_vit.pt``) or a random init from seed 0; with
    ``tp_split`` the trunk in the split layout (not sharded yet)."""
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.models.vit import ViT
    from anyloc_tpu_torch.parallel.tp import split_fused_params
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    t = DVGL[r.profile]
    net = materialize(lambda: GeoLocalizationNet("vit", "netvlad", t["clusters"],
                                                 trunc_te=t["trunc"], img_size=t["px"]),
                      _given_state(r, "dvgl_vit.pt"), r.device, seed=0)
    if tp_split:
        bb = net.backbone
        split = split_fused_params(bb.state_dict())
        net.backbone = materialize(lambda: ViT(dataclasses.replace(bb.cfg, tp_split=True)),
                                   split, r.device)
    return net


def dvgl_tuples(profile: str) -> np.ndarray:
    """dvgl's tuples [B, 1 + 1 + neg, px, px, 3] of ``DVGL``."""
    t = DVGL[profile]
    return np.random.default_rng(3).standard_normal(
        (t["tuples"], 2 + t["neg"], t["px"], t["px"], 3)).astype(np.float32)


def train_inputs(case: str, profile: str) -> dict:
    """The numpy inputs of the training cases."""
    if case == "fsdp":   # the JAX TestFSDP toy
        rng = np.random.default_rng(0)
        return {"w": rng.standard_normal((48, 64)).astype(np.float32),
                "tuples": rng.standard_normal((8, 4, 4, 4, 3)).astype(np.float32)}
    if case == "dptrain":   # the JAX dryrun: one tuple per data coordinate, 28 px
        rng = np.random.default_rng(7)
        return {"assign": rng.standard_normal((4, 384)).astype(np.float32) * 0.05,
                "centroids": rng.standard_normal((4, 384)).astype(np.float32) * 0.05}
    if case == "syncbn":
        t = SYNCBN[profile]
        rng = np.random.default_rng(11)
        return {"x": rng.standard_normal((t["batch"], *t["hw"], 3)).astype(np.float32),
                "w": rng.standard_normal((t["batch"], t["clusters"] * 256)).astype(np.float32)}
    if case == "tptrain":
        t = DVGL[profile]
        b = t["tuples"] * (2 + t["neg"])
        rng = np.random.default_rng(12)
        return {"x": rng.standard_normal((b, t["px"], t["px"], 3)).astype(np.float32),
                "w": rng.standard_normal((b, t["clusters"] * 768)).astype(np.float32)}
    raise KeyError(case)


def _adam(lr: float):
    import functools

    return functools.partial(torch.optim.Adam, lr=lr)


def _mismatches(mesh, n: int) -> int:
    """``n`` summed over every rank of the world."""
    from anyloc_tpu_torch.parallel.mesh import all_reduce

    return int(all_reduce(torch.tensor([n], dtype=torch.int64), mesh, None).item())


def _roundtrip(r: Rank, mesh, fstep, state, tuples, tag: str) -> None:
    """save -> ``load_checkpoint(target=)`` -> step against the uninterrupted
    step, and (``<tag>_spread``) a second uninterrupted run's distance from
    the first: the largest parameter difference of each, summed mismatches
    of the moments' layouts over every rank."""
    from anyloc_tpu_torch.training.triplet import TripletTrainState
    from anyloc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    ck = r.out / f"ckpt_{tag}"
    with r.sharded():
        save_checkpoint(str(ck), state._asdict(), is_best=False)
        restored = TripletTrainState(**load_checkpoint(str(ck / "last_checkpoint"),
                                                       target=state._asdict()))
    bad = sum(a.shape != b.shape for a, b in zip(state.opt_state.local.values(),
                                                  restored.opt_state.local.values()))
    bad += sum(not torch.equal(a.detach(), b.detach())
               for a, b in zip(state.params.values(), restored.params.values()))
    r.keep(f"{tag}_layout_mismatches", np.array(_mismatches(mesh, bad)))
    with r.sharded():
        cont, lc = fstep(state, tuples)
        rest, lr = fstep(restored, tuples)
    r.keep(f"{tag}_resume_losses", np.array([lc.item(), lr.item()]))
    diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in
               zip(cont.params.values(), rest.params.values()))
    mom = [(a, b) for (a, b) in zip(cont.opt_state.state_dict()["state"].values(),
                                    rest.opt_state.state_dict()["state"].values())]
    mdiff = max(float((x[k].float() - y[k].float()).abs().max()) for x, y in mom for k in x)
    r.keep(f"{tag}_resume_diff", np.array([diff, mdiff]))


def _dryrun_net(r: Rank, mesh):
    """The JAX dryrun's model: DINOv2 ViT-S/14 (4 blocks, the token facet of
    block 3, CLS dropped) + NetVLAD-4, the trunk in the split layout
    sharded over ``model``."""
    from torch import nn

    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.models.dinov2 import build_vit, dinov2_config
    from anyloc_tpu_torch.parallel.tp import shard_vit_tp, split_fused_params
    from anyloc_tpu_torch.training.aggregators import NetVLAD

    cfg = dataclasses.replace(dinov2_config("dinov2_vits14", dtype=torch.float32), tp_split=True)
    sd = vit_params(dataclasses.replace(cfg, tp_split=False), 0, r.device)
    trunk = build_vit(cfg, split_fused_params(sd), 4, device=r.device)
    shard_vit_tp(trunk, mesh)
    inp = train_inputs("dptrain", r.profile)
    head = materialize(lambda: NetVLAD(4, 384), {"assign.weight": inp["assign"],
                                                 "centroids": inp["centroids"]}, r.device)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk, self.head = trunk, head

        def forward(self, images):
            return self.head(self.trunk(images, capture_layer=3, capture_facet="token")[:, 1:])

    return Net()


def case_collectives(r: Rank) -> None:
    """The collectives under autograd (F24), x [5, 8] on every rank: the
    column -> row product ``x @ W[:, shard] @ V[shard]`` (W [8, 16], V
    [16, 3], a squared-sum loss) through ``tp_copy`` / ``tp_reduce``, its
    x, W and V gradients; through the generic ``all_reduce`` it raises;
    ``tp_gather`` of x's first 4 rows; ``sync_reduce`` of each rank's column sums
    under a loss per rank; which collectives raise under grad; with grad
    off, ``tp_copy`` is its input and ``tp_reduce`` equals ``all_reduce``."""
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel import mesh as M

    mesh = get_mesh(1, r.world)
    rng = np.random.default_rng(21)
    x0, w0, v0 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(r.device)
                  for s in ((5, 8), (8, 16), (16, 3)))
    n, i = r.world, r.rank
    cols = slice(i * 16 // n, (i + 1) * 16 // n)
    x = x0.clone().requires_grad_(True)
    w = w0[:, cols].clone().requires_grad_(True)
    v = v0[cols].clone().requires_grad_(True)
    y = M.tp_reduce((M.tp_copy(x, mesh, "model") @ w) @ v, mesh, "model")
    (y ** 2).sum().backward()
    r.keep("tp_y", y)
    r.keep("tp_grad_x", x.grad)
    with torch.no_grad():
        r.keep("tp_grad_w", M._all_gather(w.grad.t().contiguous(), mesh, "model").t())
        r.keep("tp_grad_v", M._all_gather(v.grad, mesh, "model"))
    # the gathered rows of x, a loss on the replicated result
    xr = x0[i * 4 // n:(i + 1) * 4 // n].clone().requires_grad_(True)
    g = M.tp_gather(xr, mesh, "model")
    (g.sum(0) ** 2).sum().backward()
    r.keep("gather_grad_rows", M._all_gather(xr.grad, mesh, "model"))
    # a loss per rank reading the sums over every rank
    dmesh = get_mesh(r.world, 1)
    xd = (x0 * (i + 1)).clone().requires_grad_(True)
    tot = M.sync_reduce(xd.sum(0), dmesh, "data")
    (tot * x0[i % 5]).sum().backward()
    r.keep("sync_grad", M._all_gather(xd.grad[None].contiguous(), dmesh, "data"))
    raised = []
    t = x0.clone().requires_grad_(True)
    for name, call in (("all_reduce", lambda: M.all_reduce(t * 1, mesh, "model")),
                       ("all_gather", lambda: M.all_gather(t * 1, mesh, "model")),
                       ("all_to_all", lambda: M.all_to_all(t.repeat(n, 1), mesh, "model")),
                       ("broadcast", lambda: M.broadcast(t * 1, mesh, "model")),
                       ("shift", lambda: M.shift(t * 1, mesh, "model"))):
        try:
            call()
            raised.append(False)
        except RuntimeError:
            raised.append(True)
    r.keep("raised", np.array(raised))
    with torch.no_grad():
        same = M.tp_copy(t, mesh, "model") is t
        eq = torch.equal(M.tp_reduce(x0, mesh, "model"), M.all_reduce(x0, mesh, "model"))
    r.keep("grad_off", np.array([same, eq]))


def case_fsdp(r: Rank) -> None:
    """The JAX ``TestFSDP`` toy: a [48, 64] projection, Adam 1e-3, 8 tuples
    of 4 images of 4 x 4 px, 12 steps with the moments sharded over
    ``data`` = world (min_size 512), against 12 steps on one rank; the
    bytes a rank holds; the checkpoint round trip."""
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel.fsdp import (fsdp_shardings, fsdp_train_step,
                                                state_bytes_per_device)
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step

    mesh = get_mesh(r.world, 1)
    inp = train_inputs("fsdp", r.profile)
    tuples = torch.from_numpy(inp["tuples"]).to(r.device)

    def descriptor_fn(params, images):
        d = images.reshape(images.shape[0], -1) @ params["proj"]
        return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)

    step = make_triplet_train_step(descriptor_fn, _adam(1e-3), neg_num=2)
    params = {"proj": torch.from_numpy(inp["w"]).to(r.device)}
    specs = fsdp_shardings(params, mesh, min_size=512)
    fstep = fsdp_train_step(step, specs)
    losses = []
    with r.sharded():
        state = fstep.init_state(params)
        for _ in range(12):
            state, loss = fstep(state, tuples)
            losses.append(loss.item())
    r.keep("losses", np.array(losses))
    r.keep("proj", state.params["proj"])
    r.keep("spec", np.array([str(a) for a in specs["proj"].spec]))
    local = state.opt_state.local["proj"]
    r.keep("moment_shape", np.array(state.opt_state.state[local]["exp_avg"].shape))
    r.keep("fsdp_bytes", np.array(state_bytes_per_device(state)))
    if r.rank == 0:
        one = step.init_state(params)
        single = []
        for _ in range(12):
            one, loss = step(one, tuples)
            single.append(loss.item())
        r.keep("single_losses", np.array(single))
        r.keep("single_proj", one.params["proj"])
        r.keep("replicated_bytes", np.array(state_bytes_per_device(one)))
    _roundtrip(r, mesh, fstep, state, tuples, "fsdp")


def _keep_grads(r: Rank, params: dict, tp: dict, prefix: str = "grad.") -> None:
    """Each trainable tensor's gradient, tensor-parallel shards put back
    together (every rank joins; rank 0 writes)."""
    from anyloc_tpu_torch.parallel.fsdp import _gather

    with torch.no_grad():
        for name, p in params.items():
            if p.requires_grad and p.grad is not None:
                r.keep(prefix + name, _gather(p.grad, tp.get(name)))


def _step_errors(params, moments, got_params, got_moments, lr: float) -> tuple:
    """How far one Adam step (``got_*``: the parameters after it and its
    first moments, whole) lies from another's (``params``, ``moments``):
    (the largest error of a first moment over its tensor's max|m|, among
    the tensors whose max|m| is at least 1e-3 of the largest; the largest
    over the largest |m| among the others, whose gradient vanishes in exact
    arithmetic; the largest difference of the parameters after the step,
    in units of ``lr``, at the elements of the first group whose |m| is at
    least 1e-3 of their tensor's max|m|). The first moment is 0.1 of the
    gradient; at such an element Adam's first update is lr times the
    gradient's sign to within eps / |g|, so a parameter that missed its
    update lies 1 lr off."""
    top = max(float(m.abs().max()) for m in moments.values())
    live, vanishing, update = 0.0, 0.0, 0.0
    for k, m in moments.items():
        mx = float(m.abs().max())
        err = float((got_moments[k].to(m.device, m.dtype) - m).abs().max())
        if mx < 1e-3 * top:
            vanishing = max(vanishing, err / top)
            continue
        live = max(live, err / mx)
        big = m.abs() >= 1e-3 * mx
        diff = (got_params[k].to(m.device, m.dtype) - params[k])[big].abs().max()
        update = max(update, float(diff) / lr)
    return live, vanishing, update


def case_dptrain(r: Rank) -> None:
    """Data x model training with the moments FSDP-sharded over ``data``.
    "small": the JAX dryrun (ViT-S/14 4 blocks + NetVLAD-4, 28 px, one
    tuple of 4 per data coordinate, Adam 2e-4; 2 x (world // 2) ranks, the
    trunk sharded over ``model``): the first step's loss and gradients (the
    shards put back together), 12 steps' losses, the bytes, the checkpoint
    round trip. "full": dvgl's vit + NetVLAD-64 at 224 px, 4 tuples of 12,
    data = world: the first step's loss, first moments (the averaged
    gradients, gathered whole) and parameters against the one-rank step on
    rank 0 (``_step_errors``), and a second one-rank step's distance from
    the first."""
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel.fsdp import (fsdp_shardings, fsdp_train_step,
                                                state_bytes_per_device)
    from anyloc_tpu_torch.parallel.tp import vit_tp_shardings
    from anyloc_tpu_torch.tools.train_checks import descriptor_fn
    from anyloc_tpu_torch.training.triplet import TripletTrainState, make_triplet_train_step

    if r.profile == "small":
        mesh = get_mesh(2, r.world // 2)
        net = _dryrun_net(r, mesh)
        tuples = np.random.default_rng(0).standard_normal((2, 4, 28, 28, 3)).astype(np.float32)
        neg, lr, n_steps = 2, 2e-4, 12
    else:
        mesh = get_mesh(r.world, 1)
        net = dvgl_vit(r)
        tuples = dvgl_tuples(r.profile)
        neg, lr, n_steps = DVGL[r.profile]["neg"], 1e-5, 2
    tuples = torch.from_numpy(tuples).to(r.device)
    step = make_triplet_train_step(descriptor_fn(net), _adam(lr), neg_num=neg)
    params = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    tp = vit_tp_shardings(params, mesh)
    specs = TripletTrainState(tp, fsdp_shardings(params, mesh), None)
    fstep = fsdp_train_step(step, specs)
    plain = []
    if r.profile == "full" and r.rank == 0:     # two one-rank steps on the same tuples
        for _ in range(2):
            one = step.init_state(params)
            t0 = time.perf_counter()
            one, loss1 = step(one, tuples)
            _sync(r)
            named = {k: p for k, p in one.params.items() if p.requires_grad}
            plain.append(({k: p.detach().clone() for k, p in named.items()},
                          {k: one.opt_state.state[p]["exp_avg"].clone()
                           for k, p in named.items()}))
            if len(plain) == 1:
                r.keep("single_seconds", np.array(time.perf_counter() - t0))
                r.keep("single_loss", np.array(loss1.item()))
                r.keep("replicated_adam_bytes", np.array(
                    sum(v.numel() * v.element_size() for st in one.opt_state.state.values()
                        for v in st.values())))
            del one
    losses = []
    with r.sharded():
        state = fstep.init_state(params)
        t0 = time.perf_counter()
        state, loss = fstep(state, tuples)
        _sync(r)
        r.keep("step_seconds", np.array(time.perf_counter() - t0))
    losses.append(loss.item())
    if r.profile == "full":   # the whole moments (a collective), against the one-rank step
        moments = {k: v["exp_avg"] for k, v in state.opt_state.state_dict()["state"].items()}
        if r.rank == 0:
            after = {k: state.params[k].detach() for k in plain[0][0]}
            r.keep("fsdp_vs_single", np.array(_step_errors(*plain[0], after, moments, lr)))
            r.keep("single_spread", np.array(_step_errors(*plain[0], *plain[1], lr)))
        del moments, plain
    tp_named = {k: s for k, s in tp.items() if s.dim is not None}
    _keep_grads(r, state.params, tp_named)
    with r.sharded():
        for _ in range(n_steps - 1):
            state, loss = fstep(state, tuples)
            losses.append(loss.item())
    r.keep("losses", np.array(losses))
    adam = sum(v.numel() * v.element_size() for st in state.opt_state.state.values()
               for v in st.values())
    r.keep("rank_adam_bytes", np.array(adam))
    trainable = [p for p in state.params.values() if p.requires_grad]
    r.keep("fsdp_bytes", np.array(state_bytes_per_device(state)))
    r.keep("replicated_bytes", np.array(
        sum(t.numel() * t.element_size() for t in state.params.values())
        + sum(2 * p.numel() * p.element_size() + 4 for p in trainable)))
    sharded = sum(s.dim is not None for s in state.opt_state.shardings.values())
    r.keep("sharded_moments", np.array(_mismatches(mesh, sharded)))
    _roundtrip(r, mesh, fstep, state, tuples, "dptrain")


def case_syncbn(r: Rank) -> None:
    """``GeoLocalizationNet("resnet18conv4", sync_axis="data")`` with
    ``train=True`` on each rank's images (data = world), inside
    ``use_mesh``: the outputs, the new statistics (every rank's equal) and
    the gradients of sum(out * w) summed over ``data``, against the network
    without ``sync_axis`` on the whole batch on rank 0; and that network's
    gradients on the images moved by 1e-7 of themselves, the spread a
    float32 rounding of the input gives (at 480 x 640 a random init's
    float32 gradients move by ~3e-2 of their max|g| under it). Then the
    same for the resnet18conv4 trunk alone in float64 (keys ``f64_``), with
    the loss sum(feature map * w): there the reduction's rounding is too
    small for that ill-conditioning to show, so its gradients test the
    backward of the statistics' reduction."""
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel.mesh import all_gather, all_reduce, shard_rows, use_mesh
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    mesh = get_mesh(r.world, 1)
    t = SYNCBN[r.profile]
    inp = train_inputs("syncbn", r.profile)
    x, w = (torch.from_numpy(inp[k]).to(r.device) for k in ("x", "w"))

    def net(sync):   # its own copy of the weights: materialize takes the tensors it is given
        return materialize(lambda: GeoLocalizationNet("resnet18conv4", "netvlad", t["clusters"],
                                                      sync_axis=sync),
                           _given_state(r, "syncbn.pt"), r.device, seed=0).requires_grad_(True)

    model = net("data")
    with r.sharded(), use_mesh(mesh):
        t0 = time.perf_counter()
        out = model(shard_rows(x, mesh), train=True)
        loss = (out * shard_rows(w, mesh)).sum()
        loss.backward()
        _sync(r)
        r.keep("seconds", np.array(time.perf_counter() - t0))
    with torch.no_grad():
        r.keep("out", all_gather(out.detach(), mesh, "data"))
        stats = {k: v for k, v in model.named_buffers() if k.endswith(("running_mean",
                                                                     "running_var"))}
        spread = 0.0
        for k, v in stats.items():
            every = all_gather(v[None], mesh, "data")
            spread = max(spread, float((every - every[:1]).abs().max()))
            r.keep(f"stat.{k}", v)
        r.keep("stat_spread", np.array(spread))
        for k, p in model.named_parameters():
            r.keep(f"grad.{k}", all_reduce(p.grad, mesh, "data"))
    if r.rank == 0:
        ref = net(None)
        out1 = ref(x, train=True)
        (out1 * w).sum().backward()
        r.keep("single_out", out1)
        for k, v in ref.named_buffers():
            if k.endswith(("running_mean", "running_var")):
                r.keep(f"single_stat.{k}", v)
        for k, p in ref.named_parameters():
            r.keep(f"single_grad.{k}", p.grad)
        # the gradients' own conditioning: the one-rank run on images moved
        # by 1e-7 of themselves (a float32 rounding)
        ref = net(None)
        noise = torch.from_numpy(np.random.default_rng(13).standard_normal(
            inp["x"].shape).astype(np.float32)).to(r.device)
        (ref(x * (1 + 1e-7 * noise), train=True) * w).sum().backward()
        for k, p in ref.named_parameters():
            r.keep(f"perturbed_grad.{k}", p.grad)
    _syncbn_f64(r, mesh, x.double())


def _syncbn_f64(r: Rank, mesh, x: torch.Tensor) -> None:
    """``case_syncbn``'s float64 half on the images ``x``; the arrays are
    kept in float64."""
    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.models.resnet import ResNet, resnet18_config
    from anyloc_tpu_torch.parallel.mesh import all_gather, all_reduce, shard_rows, use_mesh

    def trunk64(sync):
        cfg = resnet18_config(truncate="conv4", sync_axis=sync, dtype=torch.float64)
        return materialize(lambda: ResNet(cfg), None, r.device, seed=1).requires_grad_(True)

    def keep(name, t):
        r.keep(name, t.detach().cpu().numpy())

    def stats(model):
        return {k: v for k, v in model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}

    model = trunk64("data")
    h, w_ = model.fmap_hw(*x.shape[1:3])
    w = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (x.shape[0], h, w_, model.out_channels))).to(r.device)
    with r.sharded(), use_mesh(mesh):
        out = model(shard_rows(x, mesh), train=True)
        (out * shard_rows(w, mesh)).sum().backward()
    with torch.no_grad():
        keep("f64_out", all_gather(out.detach(), mesh, "data"))
        for k, v in stats(model).items():
            keep(f"f64_stat.{k}", v)
        for k, p in model.named_parameters():
            keep(f"f64_grad.{k}", all_reduce(p.grad, mesh, "data"))
    if r.rank == 0:
        ref = trunk64(None)
        out1 = ref(x, train=True)
        (out1 * w).sum().backward()
        keep("f64_single_out", out1)
        for k, v in stats(ref).items():
            keep(f"f64_single_stat.{k}", v)
        for k, p in ref.named_parameters():
            keep(f"f64_single_grad.{k}", p.grad)


def case_tptrain(r: Rank) -> None:
    """dvgl's vit with ``tp_split``, sharded over ``model`` = world: the
    gradients of sum(out * w) on every rank (shards put back together; the
    replicated parameters' spread across ranks), K2 with its gradient on
    the card, against the same trunk unsharded on rank 0."""
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel.mesh import all_gather
    from anyloc_tpu_torch.parallel.tp import shard_vit_tp, vit_tp_shardings

    mesh = get_mesh(1, r.world)
    inp = train_inputs("tptrain", r.profile)
    x, w = (torch.from_numpy(inp[k]).to(r.device) for k in ("x", "w"))
    net = dvgl_vit(r, tp_split=True)
    shard_vit_tp(net.backbone, mesh)
    net.requires_grad_(True)
    with r.sharded():
        t0 = time.perf_counter()
        out = net(x)
        (out * w).sum().backward()
        _sync(r)
        r.keep("seconds", np.array(time.perf_counter() - t0))
    params = dict(net.named_parameters())
    tp = {k: s for k, s in vit_tp_shardings(params, mesh).items() if s.dim is not None}
    _keep_grads(r, params, tp)
    r.keep("out", out)
    spread = 0.0
    with torch.no_grad():
        for k, p in params.items():
            if k not in tp:
                every = all_gather(p.grad[None].contiguous(), mesh, "model")
                spread = max(spread, float((every - every[:1]).abs().max()))
    r.keep("replicated_spread", np.array(spread))
    if r.rank == 0:
        ref = dvgl_vit(r, tp_split=True).requires_grad_(True)
        out1 = ref(x)
        (out1 * w).sum().backward()
        r.keep("single_out", out1)
        for k, p in ref.named_parameters():
            r.keep(f"single_grad.{k}", p.grad)


def case_restore(r: Rank) -> None:
    """``load_checkpoint(target=)`` of an FSDP state of dvgl's vit +
    NetVLAD (data = world): one step, save, restore, then the next step
    from the live state (A) and from the restored one (R), and a second
    run from the start (B) for the spread of two uninterrupted steps."""
    from anyloc_tpu_torch.parallel import get_mesh
    from anyloc_tpu_torch.parallel.fsdp import fsdp_shardings, fsdp_train_step
    from anyloc_tpu_torch.tools.train_checks import descriptor_fn
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step

    mesh = get_mesh(r.world, 1)
    net = dvgl_vit(r)
    tuples = torch.from_numpy(dvgl_tuples(r.profile)).to(r.device)
    step = make_triplet_train_step(descriptor_fn(net), _adam(1e-5),
                                   neg_num=DVGL[r.profile]["neg"])
    params = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    fstep = fsdp_train_step(step, fsdp_shardings(params, mesh))
    runs = {}
    for tag in ("a", "b"):
        with r.sharded():
            state, _ = fstep(fstep.init_state(params), tuples)
        if tag == "a":
            _roundtrip(r, mesh, fstep, state, tuples, "restore")
            runs[tag] = {k: v.detach().clone() for k, v in state.params.items()}
        else:
            with r.sharded():
                state, _ = fstep(state, tuples)
            runs[tag] = {k: v.detach() for k, v in state.params.items()}
        del state
    r.keep("spread", np.array(max(float((runs["a"][k] - runs["b"][k]).abs().max())
                                  for k in runs["a"])))


CASES = {"kmeans": case_kmeans, "search": case_search, "compressed": case_compressed,
         "extract": case_extract, "tp": case_tp, "pp": case_pp, "sp": case_sp, "ep": case_ep,
         "serve": case_serve, "collectives": case_collectives, "fsdp": case_fsdp,
         "dptrain": case_dptrain, "syncbn": case_syncbn, "tptrain": case_tptrain,
         "restore": case_restore}


def _rank_main(rank: int, world: int, backend: str, device: str, profile: str, cases,
               out: str) -> None:
    from anyloc_tpu_torch.parallel.mesh import init_distributed

    out_dir = Path(out)
    try:
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 2) // world)))
        dev = torch.device(device)
        if backend == "nccl":
            os.environ.setdefault("LOCAL_RANK", str(rank))
        init_distributed(f"file://{out_dir / 'store'}", world, rank, backend=backend)
        report = {}
        for name in cases:
            r = Rank(rank, world, dev, profile, out_dir)
            t0 = time.perf_counter()
            CASES[name](r)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            report[name] = {"seconds": time.perf_counter() - t0,
                            "launches": r.launches}
            if rank == 0:
                for key, arr in r.arrays.items():
                    np.save(out_dir / f"{name}__{key}.npy", arr)
            print(f"mesh_checks rank {rank}/{world} [{backend}, {device}] {name}: "
                  f"{report[name]['seconds']:.2f} s, launches {report[name]['launches']}",
                  flush=True)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
        import torch.distributed as dist

        dist.destroy_process_group()
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def launch(out, world: int, backend: str, device: str, profile: str, cases=None,
           timeout: float = 600.0) -> dict:
    """Run ``cases`` (default: every case of the profile) on ``world``
    ranks of a ``backend`` group on ``device``; returns {rank: {case:
    {"seconds", "launches"}}}, the launches those of the sharded calls.
    Kills the group and raises past ``timeout`` seconds or when a rank
    fails."""
    import torch.multiprocessing as mp

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cases = list(cases or (CASES_SMALL if profile == "small" else CASES_FULL))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(i, world, backend, device, profile, cases, str(out)))
             for i in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [i for i, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"mesh_checks: ranks {late} still running after {timeout} s")
        failed = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            errs = "\n".join((out / f"rank{i}.err").read_text()
                             for i in failed if (out / f"rank{i}.err").exists())
            raise RuntimeError(f"mesh_checks: ranks failed {failed}\n{errs}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return {i: json.loads((out / f"rank{i}.json").read_text()) for i in range(world)}


def results(out, case: str) -> dict:
    """{name: array} that rank 0 wrote for ``case``."""
    prefix = f"{case}__"
    return {p.name[len(prefix):-4]: np.load(p) for p in Path(out).glob(f"{prefix}*.npy")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", help=f"of {sorted(CASES)} (default: the profile's)")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", default="full", choices=["small", "full"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    report = launch(a.out, a.world, a.backend, a.device, a.profile, a.cases or None, a.timeout)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
