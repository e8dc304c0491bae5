"""MAE (Masked Autoencoder ViT): encoder and decoder (counterpart of
``anyloc_tpu/models/mae.py``; the reference's vendored models_mae.py:24-255).

The VPR use is a frozen encoder at ``mask_ratio=0`` returning latents
(scripts/mae_vlad.py:166-177): ``encode`` runs that alone, and the
forward adds the decoder, the random masking and the (optionally
pixel-normalized) reconstruction loss. Position embeddings are the fixed
2-D sin-cos ones. Masking draws its noise from a ``torch.Generator`` or
takes it as ``noise=`` (the JAX package draws it with ``jax.random``,
which torch cannot reproduce). The blocks are the shared trunk's, so
MAE-H/14's encoder runs K5 at head dim 80. Module names are the
facebookresearch/mae checkpoint's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

# the JAX package's MAE tree maps by the generic rules (blocks_i, decoder_blocks_i)
from anyloc_tpu_torch.models.convert import from_jax_params, tensors  # noqa: F401
from anyloc_tpu_torch.models.hf_convert import ensure_native_naming
from anyloc_tpu_torch.models.vit import Block, PatchEmbed, ViTConfig, layer_norm, sincos_on


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_pix_loss: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    def block_cfg(self, decoder: bool = False) -> ViTConfig:
        return ViTConfig(
            img_size=self.img_size, patch_size=self.patch_size,
            embed_dim=self.decoder_embed_dim if decoder else self.embed_dim,
            depth=self.decoder_depth if decoder else self.depth,
            num_heads=self.decoder_num_heads if decoder else self.num_heads,
            mlp_ratio=self.mlp_ratio, layerscale_init=None, ln_eps=1e-6, dtype=self.dtype)


def mae_vit_base_patch16(**kw) -> MAEConfig:
    return MAEConfig(patch_size=16, embed_dim=768, depth=12, num_heads=12, **kw)


def mae_vit_large_patch16(**kw) -> MAEConfig:
    return MAEConfig(patch_size=16, embed_dim=1024, depth=24, num_heads=16, **kw)


def mae_vit_huge_patch14(**kw) -> MAEConfig:
    return MAEConfig(patch_size=14, embed_dim=1280, depth=32, num_heads=16, **kw)


MAE_FACTORIES = {
    "mae_vit_base_patch16": mae_vit_base_patch16,
    "mae_vit_large_patch16": mae_vit_large_patch16,
    "mae_vit_huge_patch14": mae_vit_huge_patch14,
}


class MaskedAutoencoderViT(nn.Module):
    """``forward(imgs, mask_ratio, generator=None, noise=None)`` ->
    (loss, pred, mask, latent), the reference's forward with
    ``ret_latents=True``; ``encode(imgs)`` -> the unmasked latent
    [B, 1 + L, D] without the decoder. ``encoder_only`` builds no decoder
    (the extractor's model)."""

    def __init__(self, cfg: MAEConfig, encoder_only: bool = False, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        bc, dc = cfg.block_cfg(), cfg.block_cfg(decoder=True)
        f = dict(device=device, dtype=cfg.dtype)
        self.patch_embed = PatchEmbed(bc, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim, **f))
        self.blocks = nn.ModuleList([Block(bc, device) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-6, **f)
        self.encoder_only = encoder_only
        if encoder_only:
            return
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.decoder_embed_dim, **f))
        self.decoder_embed = nn.Linear(cfg.embed_dim, cfg.decoder_embed_dim, **f)
        self.decoder_blocks = nn.ModuleList([Block(dc, device) for _ in range(cfg.decoder_depth)])
        self.decoder_norm = nn.LayerNorm(cfg.decoder_embed_dim, eps=1e-6, **f)
        self.decoder_pred = nn.Linear(cfg.decoder_embed_dim, cfg.patch_size ** 2 * 3, **f)

    def patchify(self, imgs: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, L, p*p*3] (inner layout [p, p, 3] row-major,
        the reference's 'nchpwq->nhwpqc')."""
        p = self.cfg.patch_size
        b, h, w, c3 = imgs.shape
        x = imgs.reshape(b, h // p, p, w // p, p, c3).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c3)

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        p = self.cfg.patch_size
        b, n, _ = x.shape
        g = int(n ** 0.5)
        x = x.reshape(b, g, g, p, p, 3).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, g * p, g * p, 3)

    def random_masking(self, x: torch.Tensor, mask_ratio: float,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None):
        """Per-sample masking by noise argsort (models_mae.py:129-155):
        ``noise`` [B, L] uniform (drawn from ``generator`` when not given).
        Returns (x_masked, mask [B, L] (1 = removed), ids_restore)."""
        b, n, d = x.shape
        len_keep = int(n * (1 - mask_ratio))
        if noise is None:
            noise = torch.rand((b, n), generator=generator, device=x.device)
        ids_shuffle = torch.argsort(noise.to(x.device), dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        x_masked = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, d))
        mask = torch.ones((b, n), device=x.device)
        mask[:, :len_keep] = 0
        return x_masked, torch.gather(mask, 1, ids_restore), ids_restore

    def _encoder(self, imgs, mask_ratio, generator, noise):
        c = self.cfg
        b = imgs.shape[0]
        x = self.patch_embed.proj(imgs.to(c.dtype).permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos = sincos_on(c.embed_dim, c.grid, True, x.device)
        x = x + pos[:, 1:].to(x.dtype)
        n = x.shape[1]
        if mask_ratio > 0:
            x, mask, ids_restore = self.random_masking(x, mask_ratio, generator, noise)
        else:
            mask = torch.zeros((b, n), device=x.device)
            ids_restore = torch.arange(n, device=x.device)[None].expand(b, -1)
        cls = (self.cls_token.float() + pos[:, :1]).to(c.dtype)
        x = torch.cat([cls.expand(b, -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return layer_norm(c.block_cfg(), self.norm, x), mask, ids_restore

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """The latent of the unmasked image, [B, 1 + L, D]: the encoder
        alone (the forward's latent at ``mask_ratio=0``)."""
        return self._encoder(imgs, 0.0, None, None)[0]

    def forward(self, imgs: torch.Tensor, mask_ratio: float = 0.75,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        c = self.cfg
        if self.encoder_only:
            raise ValueError("an encoder-only MAE has no decoder: call encode()")
        b = imgs.shape[0]
        latent, mask, ids_restore = self._encoder(imgs, mask_ratio, generator, noise)
        y = self.decoder_embed(latent)
        dd = c.decoder_embed_dim
        n_full = ids_restore.shape[1]
        mts = self.mask_token.to(y.dtype).expand(b, n_full + 1 - y.shape[1], -1)
        y_ = torch.cat([y[:, 1:], mts], dim=1)
        y_ = torch.gather(y_, 1, ids_restore[..., None].expand(-1, -1, dd))
        y = torch.cat([y[:, :1], y_], dim=1)
        y = y + sincos_on(dd, c.grid, True, y.device).to(y.dtype)
        for blk in self.decoder_blocks:
            y = blk(y)
        y = layer_norm(c.block_cfg(decoder=True), self.decoder_norm, y)
        pred = self.decoder_pred(y)[:, 1:]
        target = self.patchify(imgs.float())
        if c.norm_pix_loss:
            mean = target.mean(-1, keepdim=True)
            var = target.var(-1, keepdim=True, unbiased=False)
            target = (target - mean) / torch.sqrt(var + 1e-6)
        err = ((pred.float() - target) ** 2).mean(-1)
        loss = (err * mask).sum() / mask.sum().clamp_min(1.0)
        return loss, pred, mask, latent


def convert_mae(sd: Dict, cfg: MAEConfig) -> Dict[str, torch.Tensor]:
    """A MAE checkpoint (facebookresearch/mae names, or HuggingFace's
    ``ViTMAEForPreTraining`` layout) -> the port's state dict. The fixed
    sin-cos ``pos_embed`` / ``decoder_pos_embed`` drop: the model computes
    them. ``decoder_pred`` needs no permutation: the reference's patchify
    is channels-last inside a patch, as this one."""
    sd = ensure_native_naming(sd, "mae")
    keep = ("patch_embed.", "cls_token", "mask_token", "norm.", "decoder_embed.",
            "decoder_norm.", "decoder_pred.")
    blocks = tuple(f"blocks.{i}." for i in range(cfg.depth)) + tuple(
        f"decoder_blocks.{i}." for i in range(cfg.decoder_depth))
    return tensors({k: v for k, v in sd.items() if k.startswith(keep + blocks)})


def encoder_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The encoder's part of a MAE state dict (an ``encoder_only`` model's)."""
    dec = ("mask_token", "decoder_")
    return {k: v for k, v in sd.items() if not k.startswith(dec)}

