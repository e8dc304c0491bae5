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
import inspect
import pkgutil

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
# the parallel/ entry points take backend= / device= after the JAX parameters.
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
                 ("parallel.sp", "SPFacetExtractor"), ("parallel.ep", "ep_vlad_aggregate")]:
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
