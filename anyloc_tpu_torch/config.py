"""Config layer: frozen dataclasses + a nested-dataclass CLI.

A copy of ``anyloc_tpu/config.py``: that module is framework-free, but
importing it runs ``anyloc_tpu/__init__.py``, which imports JAX. Mirrors the reference's tyro-based config (configs.py:59-163: ``ProgArgs``
with cache/data dirs + dataset name, ``BaseDatasetArgs`` with resize /
test_method / positive-distance threshold, composed into each pipeline's
``LocalArgs``). tyro isn't in this image, so ``parse_args`` implements the
same nested ``--prog.cache-dir``-style CLI over plain argparse.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ProgArgs:
    """Program-level arguments (reference configs.py:59-93)."""

    cache_dir: str = "./cache"
    data_vg_dir: str = "./datasets_vg/datasets"
    vg_dataset_name: str = "gardens"
    use_wandb: bool = False
    wandb_proj: str = "anyloc-tpu"
    wandb_entity: Optional[str] = None
    wandb_group: str = "default"
    wandb_run_name: Optional[str] = None


@dataclass
class BaseDatasetArgs:
    """Shared dataset arguments (reference configs.py:135-163)."""

    resize: Tuple[int, int] = (320, 320)
    test_method: str = "hard_resize"
    val_positive_dist_threshold: float = 25.0


@dataclass
class ExtractorArgs:
    model_type: str = "dinov2_vits14"
    desc_layer: int = 11
    desc_facet: str = "value"
    checkpoint: Optional[str] = None  # local torch .pth (no torch.hub egress)
    dtype: str = "bfloat16"
    batch_size: int = 32
    # Serving fast path: quant='int8_full' (frozen-trunk W8A8 kernels,
    # DINOv2 family) + transfer_dtype='uint8' (raw bytes over the H2D link,
    # normalized on-device)
    quant: Optional[str] = None
    transfer_dtype: str = "float32"


@dataclass
class VLADArgs:
    num_clusters: int = 32
    vlad_assignment: str = "hard"
    vlad_soft_temp: float = 1.0
    cache_dir: Optional[str] = None


@dataclass
class PipelineArgs:
    """Union of the per-script LocalArgs fields the pipelines need
    (e.g. dino_v2_global_vocab_vlad.py:120-210)."""

    prog: ProgArgs = field(default_factory=ProgArgs)
    bd_args: BaseDatasetArgs = field(default_factory=BaseDatasetArgs)
    extractor: ExtractorArgs = field(default_factory=ExtractorArgs)
    vlad: VLADArgs = field(default_factory=VLADArgs)
    exp_id: Optional[str] = None
    data_split: str = "test"
    sub_sample_db: int = 1
    sub_sample_qu: int = 1
    sub_sample_db_vlad: int = 1
    top_k_vals: List[int] = field(default_factory=lambda: list(range(1, 21)))
    # global-vocab pipelines: domain recipe name or explicit samples
    global_vocab: Optional[str] = None
    db_samples: Dict[str, int] = field(default_factory=dict)
    # GeM
    gem_p: float = 3.0
    gem_use_abs: bool = False
    use_distractor: bool = False
    save_results: bool = True


def _parse_kv(token: str):
    if "=" not in token:
        raise argparse.ArgumentTypeError(
            f"expected KEY=VALUE, got {token!r}"
        )
    return token


def _add_fields(parser: argparse.ArgumentParser, cls, prefix: str = ""):
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}".replace("_", "-")
        if dataclasses.is_dataclass(f.type) or dataclasses.is_dataclass(
            getattr(f.default_factory, "__call__", None) and f.default_factory()
            if f.default_factory is not dataclasses.MISSING
            else None
        ):
            sub = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
            # accumulate the FULL path — dropping the incoming prefix breaks
            # (and can collide) any dataclass nested two levels deep
            _add_fields(parser, type(sub), prefix=f"{prefix}{f.name}.")
            continue
        default = (
            f.default_factory()
            if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        if isinstance(default, bool):
            parser.add_argument(
                f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default,
            )
        elif isinstance(default, (list, tuple)):
            parser.add_argument(
                f"--{name}", nargs="*",
                type=type(default[0]) if len(default) else str, default=default,
            )
        elif isinstance(default, dict):
            parser.add_argument(f"--{name}", nargs="*", default=[],
                                type=_parse_kv, metavar="KEY=VAL")
        else:
            typ = type(default) if default is not None else str
            parser.add_argument(f"--{name}", type=typ, default=default)


def _build(cls, ns: argparse.Namespace, prefix: str = ""):
    kwargs = {}
    for f in dataclasses.fields(cls):
        sub_default = (
            f.default_factory()
            if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        if dataclasses.is_dataclass(sub_default):
            kwargs[f.name] = _build(
                type(sub_default), ns, prefix=f"{prefix}{f.name}."
            )
            continue
        key = f"{prefix}{f.name}".replace("-", "_").replace(".", "_")
        val = getattr(ns, key)
        if isinstance(sub_default, dict) and isinstance(val, list):
            def _coerce(v: str):
                try:
                    return int(v)
                except ValueError:
                    try:
                        return float(v)
                    except ValueError:
                        return v

            val = {
                kv.split("=", 1)[0]: _coerce(kv.split("=", 1)[1]) for kv in val
            }
        elif isinstance(sub_default, tuple) and isinstance(val, list):
            val = tuple(val)
        kwargs[f.name] = val
    return cls(**kwargs)


def parse_args(cls=PipelineArgs, argv: Optional[List[str]] = None):
    """Parse a nested dataclass from CLI args (``--prog.cache-dir X``,
    ``--db-samples gardens=1 pitts30k=4``)."""
    parser = argparse.ArgumentParser()
    _add_fields(parser, cls)
    ns = parser.parse_args(argv)
    # argparse stores "--prog.cache-dir" as "prog.cache_dir"; normalize
    ns2 = argparse.Namespace()
    for k, v in vars(ns).items():
        setattr(ns2, k.replace(".", "_"), v)
    return _build(cls, ns2)
