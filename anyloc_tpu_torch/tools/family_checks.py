"""Each model family's small trunk on the card against the CPU.

    python -m anyloc_tpu_torch.tools.family_checks [FAMILY ...]

Every family at 2 blocks, a narrow width and its published head dim (64;
80 for ImageBind, MAE and SAM), in float32: one state dict drawn on the
CPU runs there (the kernels' plain versions) and on the card (K5, or K2
above ``MAX_FUSED_TOKENS``; SAM's attention is plain everywhere). The
bound: the largest error within 1e-4 of the largest |value| (float32
sums in other orders). Without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from anyloc_tpu_torch.models import clip, cosplace_vit, dino_v1, imagebind, lseg, mae, sam
from anyloc_tpu_torch.models.convert import materialize
from anyloc_tpu_torch.models.dinov2 import build_vit, init_params
from anyloc_tpu_torch.ops import kernels as K

BOUND = 1e-4   # of the largest |value|
K5, K2 = ("K5_flash_attention_qkv_proj",), ("K2_flash_attention",)
F32 = torch.float32


def _narrow(cfg, d: int = 128):
    return dataclasses.replace(cfg, embed_dim=d, depth=2, num_heads=2)


def _vit(cfg):
    sd = init_params(cfg, 3, device="cpu")
    return [(lambda x, m=build_vit(cfg, sd, None, device=dev): m(x)["tokens"])
            for dev in ("cpu", "cuda")]


def _module(make, call):
    cpu = materialize(make, None, "cpu", seed=3)
    card = materialize(make, cpu.state_dict(), "cuda")
    return [lambda x: call(cpu, x), lambda x: call(card, x)]


_MAE = mae.MAEConfig(img_size=224, patch_size=14, embed_dim=160, depth=2, num_heads=2,
                     decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=4)
_SAM = sam.SAMConfig(img_size=256, patch_size=16, embed_dim=160, depth=2, num_heads=2,
                     window_size=7, global_attn_indexes=(1,), out_chans=32)

# family: (what it is, a maker of (CPU forward, card forward), image side,
# the kernels the card's forward must launch)
FAMILIES = {
    "dino_v1": ("DINO v1 stride 4, 2 heads of 64, 730 tokens",
                lambda: _vit(_narrow(dino_v1.dino_v1_config("dino_vitb8", 4, F32))), 112, K5),
    "dino_v1_long": ("DINO v1 stride 4, 1522 tokens",
                     lambda: _vit(_narrow(dino_v1.dino_v1_config("dino_vitb8", 4, F32))), 160, K2),
    "clip": ("CLIP ViT-L/14@336px's knobs (quick GELU, norm_pre, proj_out), 2 heads of 64",
             lambda: _vit(_narrow(clip.clip_vision_config("ViT-L/14@336px", F32))), 336, K5),
    "imagebind": ("ImageBind (norm_pre, no final norm), 2 heads of 80",
                  lambda: _vit(_narrow(imagebind.imagebind_vision_config(F32), 160)), 224, K5),
    "hf_vit": ("HF ViT (LayerNorm eps 1e-12), 2 heads of 64",
               lambda: _vit(_narrow(cosplace_vit.hf_vit_config(F32))), 224, K5),
    "mae": ("MAE encoder, 2 heads of 80",
            lambda: _module(lambda: mae.MaskedAutoencoderViT(_MAE, encoder_only=True),
                            lambda m, x: m.encode(x)), 224, K5),
    "lseg": ("LSeg (a 2-block backbone, 2 heads of 64, the DPT decoder)",
             lambda: _module(lambda: lseg.LSegEncoder(lseg.LSegConfig(
                 backbone=_narrow(lseg.lseg_backbone_config(F32)), hooks=(0, 1, 1, 1),
                 reassemble_dims=(32, 32, 64, 64), features=32, out_dim=64)),
                 lambda m, x: m(x)), 384, K5),
    "sam": ("SAM (windows of 7 and one global block, 2 heads of 80, plain attention)",
            lambda: _module(lambda: sam.SAMImageEncoder(_SAM),
                            lambda m, x: m(x, return_tokens=True)), 256, ()),
}


def compare(family: str) -> dict:
    """``family`` on the CPU and on the card: the output shape, the largest
    error and |value|, whether it holds the bound, the kernels launched."""
    if not torch.cuda.is_available():
        raise RuntimeError("family_checks needs a CUDA card")
    what, make, px, want = FAMILIES[family]
    cpu_fn, card_fn = make()
    x = torch.from_numpy(np.random.default_rng(px).standard_normal((2, px, px, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        ref = cpu_fn(x)
        K.reset_launch_counts()
        got = card_fn(x.cuda()).cpu()
    counts = {k: v for k, v in K.launch_counts().items() if v}
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    launched = all(counts.get(k, 0) > 0 for k in want) and bool(want or not counts)
    return dict(family=family, what=what, px=px, shape=tuple(got.shape), err=err, scale=scale,
                counts=counts, ok=err <= BOUND * scale and launched)


def run(families=None) -> list:
    """``compare`` of each of ``families`` (None: all)."""
    return [compare(f) for f in families or FAMILIES]


def line(r: dict) -> str:
    return (f"family card vs CPU (f32, 2 blocks), {r['what']}, {r['px']} px: output {r['shape']}, "
            f"max_abs_err {r['err']:.3e}, max|want| {r['scale']:.3e} (bound: max error <= "
            f"{BOUND} max|want|); kernels on the card {r['counts'] or 'none'} "
            f"{'ok' if r['ok'] else 'FAIL'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*", help=f"some of {list(FAMILIES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = set(args.families) - set(FAMILIES)
    if unknown:
        ap.error(f"unknown families {sorted(unknown)}")
    results = run(args.families)
    for r in results:
        print(line(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
