"""Checkpoint conversion helpers (counterpart of
``anyloc_tpu/models/convert.py``), and the loader of the JAX package's
parameter trees.

The numpy helpers are the JAX package's own (its layouts: Dense kernels
[in, out], Conv kernels HWIO); the port's converters mostly rename, since
its modules keep torch's layouts. ``from_jax_params`` goes the other way:
a Flax tree of the JAX package -> a state dict of the port.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def t2np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def linear_kernel(w) -> np.ndarray:
    """torch Linear weight [out, in] -> flax Dense kernel [in, out]."""
    return t2np(w).T


def conv_kernel(w) -> np.ndarray:
    """torch Conv2d weight [out, in, kh, kw] -> flax Conv kernel [kh, kw, in, out]."""
    return t2np(w).transpose(2, 3, 1, 0)


def ln_params(sd: Mapping, prefix: str) -> Dict:
    return {"scale": t2np(sd[f"{prefix}.weight"]), "bias": t2np(sd[f"{prefix}.bias"])}


def dense_params(sd: Mapping, prefix: str, bias: bool = True) -> Dict:
    out = {"kernel": linear_kernel(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = t2np(sd[f"{prefix}.bias"])
    return out


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A local .pth / .pt state dict -> {name: float32 numpy array},
    unwrapped from "state_dict" / "model" / "model_state_dict" / "teacher"
    where a trainer nested it."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict):
        for key in ("state_dict", "model", "model_state_dict", "teacher"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    return {k: t2np(v) for k, v in sd.items()
            if hasattr(v, "detach") or isinstance(v, np.ndarray)}


def strip_prefix(sd: Mapping, prefix: str) -> Dict:
    """Drop a wrapper prefix ('module.', 'backbone.', ...) from all keys."""
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


def maybe_tp_split(params: Dict, cfg) -> Dict:
    """The tree unchanged unless ``cfg.tp_split`` asks for the
    tensor-parallel layouts, which the port has not reached."""
    if cfg.tp_split:
        raise NotImplementedError(
            'tp_split is not ported yet (ROADMAP.md, port queue: "parallel/ on '
            'torch.distributed")')
    return params


def tensor(v) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as a CPU tensor."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, order="C"))


def tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: tensor(v) for k, v in sd.items()}


_INDEXED = re.compile(r"^(.+)_(\d+)$")
_INNER_INDEX = re.compile(r"^([A-Za-z]\w*?)_(\d+)_([A-Za-z]\w*)$")
_WHOLE = re.compile(r"^filter_\d+_\d+$")   # CRN's context convs keep their names
Rename = Callable[[str, np.ndarray], Optional[Tuple[str, np.ndarray]]]


def _split(name: str, leaf: bool = False) -> list:
    """A Flax name -> the port's path parts: ``name_{i}`` -> name, i (a
    module, not a leaf); ``name_{i}_rest`` -> name, i, rest (the flat
    names of CCT, ImageBind's trunks and Swin's stages); CRN's
    ``filter_{k}_{k}`` stays whole."""
    if _WHOLE.match(name):
        return [name]
    m = _INNER_INDEX.match(name)
    if m:
        return [m.group(1), m.group(2)] + _split(m.group(3), leaf)
    m = None if leaf else _INDEXED.match(name)
    return [m.group(1), m.group(2)] if m else [name]


def from_jax_params(params, rename: Optional[Rename] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax variables (numpy leaves: a parameter tree, or
    a variables dict with "params" and, for BatchNorm, "batch_stats") ->
    this port's state dict: HWIO conv kernel -> OIHW (a grouped conv's
    [kh, kw, in / groups, out] -> torch's [out, in / groups, kh, kw]),
    Dense kernel [in, out] -> weight [out, in], LayerNorm / BatchNorm
    ``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``, BatchNorm
    ``mean`` / ``var`` -> ``running_mean`` / ``running_var``, indexed
    modules ``name_{i}`` -> ``name.{i}``, flat names ``name_{i}_rest`` ->
    ``name.{i}.rest``, ``patch_embed`` -> ``patch_embed.proj``. A quantized
    tree (``quantize_vit_params``) keeps its types: int8 ``kernel_q`` [in,
    out] -> ``weight_q`` [out, in], f32 ``kernel_scale`` ->
    ``weight_scale``. The fused qkv column order (q|k|v, head-minor) is
    the same in both. ``rename(key, array)`` then maps each entry to its
    family's name and layout (None drops it)."""
    trees = ([params["params"]] + ([params["batch_stats"]] if "batch_stats" in params else [])
             if "params" in params else [params])
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        parts = []
        for p in path[:-1]:
            parts += _split(p)
            if p == "patch_embed":
                parts.append("proj")
        leaf = path[-1]
        arr = np.asarray(node, np.int8 if leaf == "kernel_q" else np.float32)
        if leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "kernel_q":
            leaf, arr = "weight_q", arr.T
        leaf = {"kernel_scale": "weight_scale", "scale": "weight", "embedding": "weight",
                "mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        key = ".".join(parts + _split(leaf, leaf=True))
        if rename is not None:
            renamed = rename(key, arr)
            if renamed is None:
                return
            key, arr = renamed
        out[key] = torch.from_numpy(np.array(arr, order="C"))   # a writable copy

    for tree in trees:
        walk(tree, [])
    return out


@torch.no_grad()
def random_init_(module: torch.nn.Module, seed: int, stds: Optional[Mapping[str, float]] = None
                 ) -> torch.nn.Module:
    """Random shape-true weights in place, drawn on the module's device
    from a ``torch.Generator`` seeded with ``seed`` (no pretrained weights
    are available): Linear / Conv weights normal(0, 1/sqrt(fan_in)),
    biases 0, LayerNorm and BatchNorm 1 / 0 with running statistics 0 / 1,
    Embeddings and every other parameter normal(0, 0.02), or the std that
    ``stds`` gives for a name ending in one of its keys (0: zeros); then
    each submodule's ``init_constants_()``, where it has one, sets the
    parameters that start at a constant (GeM's p, Swin's logit scale)."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(t: torch.Tensor, std: float) -> None:
        if std == 0:
            t.zero_()
        else:
            t.copy_(torch.empty(t.shape, device=device).normal_(0.0, std, generator=gen))

    done = set()
    for mname, mod in module.named_modules():
        pre = f"{mname}." if mname else ""
        w, b = getattr(mod, "weight", None), getattr(mod, "bias", None)
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            fill(w, w[0].numel() ** -0.5)
        elif isinstance(mod, torch.nn.Embedding):
            fill(w, 0.02)
        elif isinstance(w, torch.Tensor) and w.dim() == 1 and isinstance(b, torch.Tensor):
            w.fill_(1.0)   # LayerNorm, LayerNorm2d, FrozenBN
        else:
            continue
        if isinstance(b, torch.Tensor):
            b.zero_()
        done.update({pre + "weight", pre + "bias"})
        for buf, value in (("running_mean", 0.0), ("running_var", 1.0)):
            if isinstance(getattr(mod, buf, None), torch.Tensor):
                getattr(mod, buf).fill_(value)
    for name, p in params.items():
        if name not in done:
            std = next((v for k, v in (stds or {}).items() if name.endswith(k)), 0.02)
            fill(p, std)
    for mod in module.modules():   # parameters whose init is a constant (GeM's p, ...)
        if hasattr(mod, "init_constants_"):
            mod.init_constants_()
    return module


def materialize(make: Callable[[], torch.nn.Module], state_dict: Optional[Mapping], device,
                seed: int = 42, stds: Optional[Mapping[str, float]] = None) -> torch.nn.Module:
    """``make()`` built without memory, then filled: from ``state_dict``
    (torch tensors or numpy arrays in the module's naming, strict, each
    cast to its declared dtype) or, when it is None, by ``random_init_`` on
    ``device``. Frozen and in eval mode."""
    with torch.device("meta"):
        model = make()
    if state_dict is None:
        model = random_init_(model.to_empty(device=device), seed, stds)
    else:
        declared = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        sd = {k: tensor(v).to(declared[k].dtype) if k in declared else tensor(v)
              for k, v in state_dict.items()}
        model.load_state_dict(sd, strict=True, assign=True)
        model = model.to(device=device)
    return model.requires_grad_(False).eval()
