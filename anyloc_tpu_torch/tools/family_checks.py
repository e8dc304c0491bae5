"""Each model family's small trunk, and each trained-baseline network at
full width and depth, on the card against the CPU.

    python -m anyloc_tpu_torch.tools.family_checks [FAMILY | NETWORK ...]

Every family at 2 blocks, a narrow width and its published head dim (64;
80 for ImageBind, MAE and SAM), in float32: one state dict drawn on the
CPU runs there (the kernels' plain versions) and on the card (K5, or K2
above ``MAX_FUSED_TOKENS``; SAM's attention is plain everywhere). The
networks (``NETWORKS``: VGG-16, AlexNet, CCT-14/7x2, EfficientNet-b0 /
b7, SwinV2-B, the CRN and RRM heads on ResNet-18 conv4, ImageBind-H's
five towers) run float32 at their published widths, one random state
drawn on the CPU (BatchNorm statistics calibrated on the input, so the
activations keep their scale), with cuDNN's flags at PyTorch's defaults (F17: the
port's convolutions run in full float32 on their own). The bound: the
largest error within 1e-4 of the largest |value| (float32 sums in other
orders). Without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from anyloc_tpu_torch.models import (cct, clip, cosplace_vit, dino_v1, efficientnet, imagebind,
                                     lseg, mae, resnet, sam, swin)
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


def _geo(aggregation):
    from anyloc_tpu_torch.training.network import GeoLocalizationNet

    return lambda: GeoLocalizationNet("resnet18conv4", aggregation)


def _imagebind_inputs(rng, b):
    ids = rng.integers(1, 49406, (b, 77))
    ids[:, 12] = 49407   # EOT
    return {"vision": rng.standard_normal((b, 224, 224, 3)), "text": ids,
            "audio": rng.standard_normal((b, 128, 204)),
            "depth": rng.standard_normal((b, 224, 224)),
            "thermal": rng.standard_normal((b, 224, 224)),
            "imu": rng.standard_normal((b, 6, 2000))}


# network: (what it is, a maker of the module, input [H, W], the kernels
# its card forward must launch); "imagebind_huge" is the multimodal model
NETWORKS = {
    "vgg16": ("VGG-16 features (dvgl), 13 convs x 512", resnet.VGG16, (480, 640), ()),
    "alexnet": ("AlexNet features[:-2] (dvgl)", resnet.AlexNet, (480, 640), ()),
    "cct384": ("CCT-14/7x2 (14 blocks x 384, seq-pool)",
               lambda: cct.CCT(cct.cct_14_7x2_384()), (384, 384), ()),
    "efficientnet_b0": ("EfficientNet-b0 (16 MBConv, 1280 out)",
                        lambda: efficientnet.EfficientNet(efficientnet.efficientnet_config("b0")),
                        (320, 320), ()),
    "efficientnet_b7": ("EfficientNet-b7 (55 MBConv, 2560 out)",
                        lambda: efficientnet.EfficientNet(efficientnet.efficientnet_config("b7")),
                        (320, 320), ()),
    "swinv2_base": ("SwinV2-B (2-2-18-2 x 128, window 16)",
                    lambda: swin.SwinV2(swin.swinv2_base_config(img_size=320)), (320, 320), ()),
    "crn": ("ResNet-18 conv4 + CRN-64", _geo("crn"), (480, 640), ()),
    "rrm": ("ResNet-18 conv4 + RRM", _geo("rrm"), (480, 640), ()),
    "imagebind_huge": ("ImageBind-H (vision 32 x 1280, text 24 x 1024, audio / depth / thermal "
                       "12 x 768, IMU 6 x 512)", None, (224, 224), K5),
}


def _flat(out) -> torch.Tensor:
    if isinstance(out, dict):
        return torch.cat([o.float().flatten() for o in out.values()])
    return out.float().flatten()


def calibrate_bn_(model: torch.nn.Module, x: torch.Tensor) -> None:
    """Each BatchNorm's running statistics from its own input on ``x`` (a
    random init has none: with mean 0 / var 1 the activations of a deep
    CNN shrink towards zero, and a card-vs-CPU bound relative to them
    checks little). One forward, in layer order."""
    def hook(mod, args):
        a = args[0].float()
        mod.running_mean.copy_(a.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(a.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, resnet.BatchNorm)]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()


def compare_network(name: str, batch: int = 2, seed: int = 3) -> dict:
    """``name`` of ``NETWORKS`` on the CPU and on the card, one state: the
    largest error and |value|, whether it holds the bound, the kernels
    launched, the card's forward ms at ``batch``."""
    from anyloc_tpu_torch.tools._timing import require_card, time_ms

    dev = require_card("family_checks")
    what, make, (h, w), want = NETWORKS[name]
    rng = np.random.default_rng(seed)
    with torch.inference_mode():
        if make is None:
            model = imagebind.ImageBindModel(seed=seed, device="cpu")
            x = {k: torch.from_numpy(v.astype(np.int64 if k == "text" else np.float32))
                 for k, v in _imagebind_inputs(rng, batch).items()}
            ref = model(x)
            model.to(dev)
            xd = {k: v.to(dev) for k, v in x.items()}

            def card():
                return model(xd)
        else:
            cpu = materialize(make, None, "cpu", seed=seed)
            x = torch.from_numpy(rng.standard_normal((batch, h, w, 3)).astype(np.float32))
            calibrate_bn_(cpu, x)
            ref = cpu(x)
            model = materialize(make, cpu.state_dict(), dev)
            del cpu
            xd = x.to(dev)

            def card():
                return model(xd)
        K.reset_launch_counts()
        got = card()
        torch.cuda.synchronize()
        counts = {k: v for k, v in K.launch_counts().items() if v}
        shapes = {k: tuple(v.shape) for k, v in got.items()} if isinstance(got, dict) else \
            tuple(got.shape)
        got, ref = _flat(got).cpu(), _flat(ref)
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        ms = time_ms(card, iters=3, reps=2, warmup=1)
    launched = all(counts.get(k, 0) > 0 for k in want) and bool(want or not counts)
    del model
    torch.cuda.empty_cache()
    return dict(family=name, what=what, px=(h, w), shape=shapes, err=err, scale=scale,
                counts=counts, ms=ms, batch=batch,
                finite=bool(torch.isfinite(got).all()),
                ok=err <= BOUND * scale and launched and bool(torch.isfinite(got).all()))


def network_line(r: dict) -> str:
    return (f"network card vs CPU (f32, full depth), {r['what']}, {r['px'][0]}x{r['px'][1]}, "
            f"batch {r['batch']}: output {r['shape']}, max_abs_err {r['err']:.3e}, max|want| "
            f"{r['scale']:.3e} (bound: max error <= {BOUND} max|want|); card forward "
            f"{r['ms']:.2f} ms; kernels on the card {r['counts'] or 'none'} "
            f"{'ok' if r['ok'] else 'FAIL'}")


def run(families=None) -> list:
    """``compare`` of each of ``families`` (None: all small families)."""
    return [compare_network(f) if f in NETWORKS else compare(f) for f in families or FAMILIES]


def line(r: dict) -> str:
    return (f"family card vs CPU (f32, 2 blocks), {r['what']}, {r['px']} px: output {r['shape']}, "
            f"max_abs_err {r['err']:.3e}, max|want| {r['scale']:.3e} (bound: max error <= "
            f"{BOUND} max|want|); kernels on the card {r['counts'] or 'none'} "
            f"{'ok' if r['ok'] else 'FAIL'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*",
                    help=f"some of {list(FAMILIES) + list(NETWORKS)} (default: the families)")
    args = ap.parse_args(argv)
    unknown = set(args.families) - set(FAMILIES) - set(NETWORKS)
    if unknown:
        ap.error(f"unknown families {sorted(unknown)}")
    results = run(args.families)
    for r in results:
        print((network_line if r["family"] in NETWORKS else line)(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
