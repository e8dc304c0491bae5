"""F14: every public callable that the port shares by name with its JAX
module takes the JAX parameters in their JAX positions.

For each module of ``anyloc_tpu_torch`` whose path exists in
``anyloc_tpu``, every public function or class defined there that the JAX
module also defines is compared by ``inspect.signature`` (a class by its
constructor, a dataclass or Flax module by its fields): the JAX
parameter names must open the port's list, in order; the port's own
keywords (``device``, ``init_*``, ``generator``, ...) come after them.
Flax modules end with ``parent`` and ``name``, which a torch module does
not take. Every other exception is named below with its reason.
"""

import importlib
import importlib.util
import inspect
import pathlib
import pkgutil
import sys

import flax.linen as fnn
import pytest

import anyloc_tpu_torch

# (module, name) -> the JAX parameters the port leaves out, the port's in
# their place, and why
DROPPED = {
    ("ops.kmeans", "kmeans_fit"): (
        {"key"}, set(), "F2: the start rows come from init_centers= or a torch.Generator; "
                        "torch cannot reproduce jax.random"),
    ("ops.kmeans", "kmeans_fit_streamed"): ({"key"}, set(), "F2, as kmeans_fit"),
    ("ops.quant", "quantize_vit_params"): (
        {"params"}, {"state_dict"}, "it quantizes the port's state dict (in the same "
                                    "position), not a Flax tree"),
    **{("data.augment", name): ({"key"}, {"generator"}, "F2: the draws come from a "
                                "torch.Generator in the key's position")
       for name in ("color_jitter", "random_resized_crop", "random_rotation",
                    "random_perspective")},
    ("parallel.distributed", "kmeans_fit_sharded"): (
        {"key"}, set(), "F2: the start rows come from init_rows= or a torch.Generator"),
    ("parallel.sp", "ring_attention"): (
        {"vary_axes"}, set(), "shard_map's varying-axes typing; an SPMD rank has none (the "
                              "ring's group comes from mesh=, after the JAX parameters)"),
}
# Not a name difference, so not listed: ``mesh`` is a torch DeviceMesh with the
# JAX axis names where the JAX package takes a jax Mesh (parallel/mesh.py), and
# the parallel/ entry points take backend= / device= after the JAX parameters;
# the viz subcommands and ``viz.cluster_assignment_map`` / ``pca_projection``
# take device= after them (the card by default); ``state_shardings`` and the
# leaves of ``fsdp_shardings`` are ``parallel.fsdp.Sharding`` values (mesh +
# spec) where the JAX package has NamedShardings; a layer given ``sync_axis``
# reduces over the mesh of ``parallel.mesh.use_mesh`` where the JAX package's
# ``shard_map`` binds the axis name.
# not ported yet: each raises NotImplementedError naming its port-queue item
STUBS = set()


def _shared():
    """(module suffix, name, port object, JAX object) of every public
    callable both packages define under the same module path."""
    out = []
    for info in pkgutil.walk_packages(anyloc_tpu_torch.__path__, "anyloc_tpu_torch."):
        if info.name.endswith("__main__"):
            continue
        suffix = info.name[len("anyloc_tpu_torch."):]
        try:
            jmod = importlib.import_module(f"anyloc_tpu.{suffix}")
        except ImportError:
            continue
        pmod = importlib.import_module(info.name)
        for name, obj in vars(pmod).items():
            if (name.startswith("_") or getattr(obj, "__module__", None) != info.name
                    or not (inspect.isfunction(obj) or inspect.isclass(obj))):
                continue
            jobj = getattr(jmod, name, None)
            if callable(jobj) and getattr(jobj, "__module__", None) == jmod.__name__:
                out.append((suffix, name, obj, jobj))
    return out


SHARED = _shared()


def _params(obj):
    return list(inspect.signature(obj).parameters)


def test_the_comparison_covers_the_ported_modules():
    names = {(m, n) for m, n, _, _ in SHARED}
    for want in [("models.factory", "make_extractor"), ("pipelines.engine", "DescriptorEngine"),
                 ("models.clip", "ClipWrapper"), ("models.vit", "ViTConfig"),
                 ("ops.vlad", "vlad_aggregate"), ("data.transforms", "device_normalize"),
                 ("ops.common", "l2_normalize"), ("models.sam", "SAMImageEncoder"),
                 ("parallel.mesh", "get_mesh"), ("parallel.distributed", "pq_search_sharded"),
                 ("parallel.tp", "split_fused_params"), ("parallel.pp", "pipeline_facet_extract"),
                 ("parallel.sp", "SPFacetExtractor"), ("parallel.ep", "ep_vlad_aggregate"),
                 ("parallel.fsdp", "fsdp_train_step"), ("parallel.fsdp", "fsdp_shardings"),
                 ("parallel.tp", "vit_tp_shardings"), ("utils.checkpoint", "load_checkpoint"),
                 ("viz", "cluster_assignment_map"), ("pipelines.viz_cli", "cmd_report"),
                 ("utils.profiling", "flops_of"), ("utils.images", "to_pil_list"),
                 ("data.transforms", "resize_pil")]:
        assert want in names, want
    assert set(DROPPED) | STUBS <= names, (set(DROPPED) | STUBS) - names


@pytest.mark.parametrize("module,name", sorted((m, n) for m, n, _, _ in SHARED))
def test_jax_parameters_open_the_ports_signature(module, name):
    _, _, obj, jobj = next(s for s in SHARED if s[:2] == (module, name))
    if (module, name) in STUBS:
        with pytest.raises(NotImplementedError, match="port queue"):
            obj()
        return
    want = _params(jobj)
    if inspect.isclass(jobj) and issubclass(jobj, fnn.Module):
        assert want[-2:] == ["parent", "name"]
        want = want[:-2]   # Flax's own fields
    dropped, replaced, reason = DROPPED.get((module, name), (set(), set(), ""))
    assert dropped <= set(want), (dropped, want)
    want = [p for p in want if p not in dropped]
    got = [p for p in _params(obj) if p not in replaced]
    assert got[:len(want)] == want, (got, want, reason)


# The port's counterparts of the repository's JAX programs outside the
# package (tools/, examples/, __graft_entry__.py): port module -> JAX file.
ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAMS = {
    "tools.dryrun": "__graft_entry__.py",
    "tools.bench_serving": "tools/bench_serving.py",
    "tools.bench_ivf": "tools/bench_ivf.py",
    "tools.bench_pq_matrix": "tools/bench_pq_matrix.py",
    "tools.bench_mlp_xla_int8": "tools/bench_mlp_xla_int8.py",
    "tools.bench_retrieval": "bench_retrieval.py",
    "examples.quickstart": "examples/quickstart.py",
    "examples.serving": "examples/serving.py",
    "examples.multichip_retrieval": "examples/multichip_retrieval.py",
}
# The device= differences of these programs: each port callable below takes
# ``device`` after the JAX parameters (None: the card), where the JAX
# program runs on whatever backend JAX was given; every ``main`` takes
# ``argv`` (its flags; the examples' ``--cpu``), where the JAX ``main``
# reads sys.argv.
DEVICE_KW = {("tools.dryrun", "entry"), ("tools.dryrun", "dryrun_multichip")}


def _program_pairs():
    sys.path.insert(0, str(ROOT))
    out = []
    for suffix, rel in sorted(PROGRAMS.items()):
        spec = importlib.util.spec_from_file_location(f"jax_program_{suffix}", ROOT / rel)
        jmod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jmod)
        pmod = importlib.import_module(f"anyloc_tpu_torch.{suffix}")
        for name, obj in vars(pmod).items():
            if (name.startswith("_") or getattr(obj, "__module__", None) != pmod.__name__
                    or not inspect.isfunction(obj)):
                continue
            jobj = getattr(jmod, name, None)
            if inspect.isfunction(jobj) and jobj.__module__ == jmod.__name__:
                out.append((suffix, name, obj, jobj))
    return out


PROGRAM_PAIRS = _program_pairs()


def test_the_programs_share_their_entry_points():
    """``entry`` and ``dryrun_multichip``, and each tool's and example's
    ``main``, are shared by name (``__graft_entry__.py`` has no ``main``:
    its ``__main__`` block is the port's ``dryrun.main``)."""
    names = {(m, n) for m, n, _, _ in PROGRAM_PAIRS}
    assert {("tools.dryrun", "entry"), ("tools.dryrun", "dryrun_multichip")} <= names
    mains = {(m, "main") for m in PROGRAMS if m != "tools.dryrun"}
    assert mains <= names, mains - names
    assert DEVICE_KW <= names


@pytest.mark.parametrize("module,name", sorted((m, n) for m, n, _, _ in PROGRAM_PAIRS))
def test_jax_programs_parameters_open_the_ports_signature(module, name):
    """The JAX program's parameters open the port's; ``device`` comes after
    them where ``DEVICE_KW`` names it, and only there."""
    _, _, obj, jobj = next(s for s in PROGRAM_PAIRS if s[:2] == (module, name))
    want, got = _params(jobj), _params(obj)
    assert got[:len(want)] == want, (got, want)
    assert ("device" in got[len(want):]) == ((module, name) in DEVICE_KW), got
