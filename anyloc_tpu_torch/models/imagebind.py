"""ImageBind's vision trunk (counterpart of the vision part of
``anyloc_tpu/models/imagebind.py``; the reference evaluates it in
scripts/imagebind_global_vpr.py).

imagebind_huge's vision geometry: 1280 wide, 32 blocks of 16 heads (head
dim 80: K5 at 257 tokens), 14-px patches (the reference's 3-D patch conv
over two duplicated frames collapses to a 2-D conv, exactly, for still
images), CLS, a learned pre-transformer LayerNorm (``norm_pre``) and no
trunk-final LayerNorm: that one lives in the modality head, LN -> CLS ->
Linear(1280, 1024) -> L2 normalize (imagebind_extractor.py:1403-1410,
1466-1470).

The multimodal surface (``ImageBindModel``): the text tower (1024 x 24 x
16, causal, CLIP BPE ids, EOS pooling), audio (768 x 12 x 12, a 16 / 10
conv over a 128-mel x 204-frame log-mel), depth and thermal (768 x 12 x
12, a 1-channel 16 / 16 conv) and IMU (512 x 6 x 8, linear patches of 8
over [6, 2000]), each L2-normalized and multiplied by its modality's
logit scale. Their trunks are ``_SimpleTrunk`` (torch MultiheadAttention
semantics, a learned bias_k / bias_v position for the patch towers, no
trunk-final LayerNorm) with plain attention, as in the JAX package; the
vision tower is the ViT-H trunk (K5 on the card). The towers' token
counts are taken at construction (Flax takes them from the first
input): ``in_hw`` for the conv stems, ``n_tokens`` for IMU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the JAX package's vision trunk tree is the generic ViT tree
from anyloc_tpu_torch.models.convert import (from_jax_params, materialize,  # noqa: F401
                                             maybe_tp_split, t2np, tensors)
from anyloc_tpu_torch.models.vit import ViTConfig
from anyloc_tpu_torch.ops.common import Conv2d, l2_normalize, resolve_device


class ModalityType:   # API parity (imagebind_extractor.py:1115)
    VISION = "vision"
    TEXT = "text"
    AUDIO = "audio"
    THERMAL = "thermal"
    DEPTH = "depth"
    IMU = "imu"


def imagebind_vision_config(dtype=None, img_size: int = 224) -> ViTConfig:
    kwargs = dict(
        img_size=img_size, patch_size=14, embed_dim=1280, depth=32, num_heads=16,
        mlp_type="mlp", layerscale_init=None, ln_eps=1e-6, pre_norm=True, final_norm=False,
        interpolate_offset=0.0,
        patch_bias=False,   # the reference's Conv3d stem has no bias (F15)
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


class ImageBindVision:
    """The vision extractor of the VPR path: ``__call__(imgs)`` ->
    {"cls": the modality head's embedding [B, 1024] (LN -> CLS -> Linear,
    L2-normalized, float32), "tokens": the trunk's patch tokens [B, N, D]
    (float32)} on ``device`` (None: the card). ``checkpoint`` is a local
    ImageBind ``.pth``; None means a random trunk from ``seed`` and a
    random head from ``seed + 1``. ``params`` / ``head`` give the trunk's
    state dict and (head LayerNorm {"weight", "bias"}, head matrix
    [1280, 1024]) instead."""

    def __init__(self, checkpoint: Optional[str] = None, dtype=torch.bfloat16,
                 seed: int = 42, *, device: Union[None, str, torch.device] = None,
                 params: Optional[Dict] = None,
                 head: Optional[Tuple[Dict, object]] = None) -> None:
        from anyloc_tpu_torch.models.dinov2 import build_vit, init_params

        self.cfg = imagebind_vision_config(dtype=dtype)
        self.device = resolve_device(device)
        if checkpoint is not None:
            from anyloc_tpu_torch.models.convert import load_torch_checkpoint

            sd = load_torch_checkpoint(checkpoint)
            params = convert_imagebind_vision(sd, self.cfg)
            head = convert_imagebind_vision_head(sd)
        if params is None:
            params = init_params(self.cfg, seed, device=self.device)
        self.model = build_vit(self.cfg, params, None, device=self.device)
        d = self.cfg.embed_dim
        if head is None:
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            head = ({"weight": torch.ones(d), "bias": torch.zeros(d)},
                    torch.randn((d, 1024), generator=gen, device=self.device) * 0.02)
        ln, w = head
        self.head_ln = {k: torch.as_tensor(t2np(v)).to(self.device) for k, v in ln.items()}
        self.head_w = torch.as_tensor(t2np(w)).to(self.device)

    @torch.inference_mode()
    def __call__(self, imgs, modality: str = ModalityType.VISION) -> Dict[str, torch.Tensor]:
        if modality != ModalityType.VISION:
            raise NotImplementedError(
                "ImageBindVision is the vision-only extractor; use ImageBindModel for the "
                "multimodal surface")
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        imgs = imgs.to(self.device, torch.float32)
        if imgs.dim() == 3:
            imgs = imgs[None]
        out = self.model(imgs)
        # the trunk-final LayerNorm lives in the head (reference :1466-1470)
        pre = out["pre_norm_tokens"][:, 0].float()
        mu = pre.mean(-1, keepdim=True)
        var = ((pre - mu) ** 2).mean(-1, keepdim=True)
        normed = (pre - mu) / torch.sqrt(var + 1e-6) * self.head_ln["weight"] + self.head_ln["bias"]
        return {"cls": l2_normalize(normed @ self.head_w), "tokens": out["tokens"].float()}


def convert_imagebind_vision(sd: Dict, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """An ImageBind checkpoint (``modality_*.vision.*``) -> the vision
    trunk's state dict. The 3-D patch kernel [D, 3, T, p, p] sums over
    time (still images duplicate the frame: an exact equivalence); the
    pre-transformer LayerNorm is ``norm_pre``."""
    vp, vt = "modality_preprocessors.vision.", "modality_trunks.vision."
    out = {
        "patch_embed.proj.weight": t2np(sd[f"{vp}rgbt_stem.proj.1.weight"]).sum(axis=2),
        "cls_token": sd[f"{vp}cls_token"],
        "pos_embed": sd[f"{vp}pos_embedding_helper.pos_embed"],
        "norm_pre.weight": sd[f"{vt}pre_transformer_layer.0.weight"],
        "norm_pre.bias": sd[f"{vt}pre_transformer_layer.0.bias"],
    }
    for i in range(cfg.depth):
        h, b = f"{vt}blocks.{i}", f"blocks.{i}"
        out[f"{b}.attn.qkv.weight"] = sd[f"{h}.attn.in_proj_weight"]
        out[f"{b}.attn.qkv.bias"] = sd[f"{h}.attn.in_proj_bias"]
        for ours, theirs in (("norm1", "norm_1"), ("norm2", "norm_2"),
                             ("attn.proj", "attn.out_proj"), ("mlp.fc1", "mlp.fc1"),
                             ("mlp.fc2", "mlp.fc2")):
            for kind in ("weight", "bias"):
                out[f"{b}.{ours}.{kind}"] = sd[f"{h}.{theirs}.{kind}"]
    return maybe_tp_split(tensors({k: t2np(v) for k, v in out.items()}), cfg)


def convert_imagebind_vision_head(sd: Dict) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``modality_heads.vision``: LN(1280) -> CLS -> Linear(1280, 1024, no
    bias) (imagebind_extractor.py:1466-1470) -> ({"weight", "bias"} of the
    LN, the matrix [1280, 1024] that multiplies the CLS row)."""
    ln = {k: torch.from_numpy(t2np(sd[f"modality_heads.vision.0.{k}"])) for k in ("weight", "bias")}
    return ln, torch.from_numpy(np.ascontiguousarray(t2np(sd["modality_heads.vision.2.weight"]).T))


def from_jax_head(head_ln: Dict, head_w) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The JAX package's head (``ImageBindVision.head_ln`` {"scale",
    "bias"} and ``head_w`` [1280, 1024]) -> the port's ``head``."""
    return ({"weight": torch.from_numpy(t2np(head_ln["scale"])),
             "bias": torch.from_numpy(t2np(head_ln["bias"]))},
            torch.from_numpy(t2np(head_w).copy()))


def _block_cfg(embed_dim, depth, heads, dtype) -> ViTConfig:
    return ViTConfig(embed_dim=embed_dim, depth=depth, num_heads=heads, layerscale_init=None,
                     ln_eps=1e-6, dtype=dtype)


class _SimpleBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, bias_kv: bool) -> None:
        super().__init__()
        d, t = cfg.embed_dim, cfg.dtype
        self.norm1 = nn.LayerNorm(d, eps=cfg.ln_eps, dtype=t)
        self.qkv = nn.Linear(d, 3 * d, dtype=t)
        self.proj = nn.Linear(d, d, dtype=t)
        if bias_kv:
            self.bias_k = nn.Parameter(torch.zeros(d, dtype=t))
            self.bias_v = nn.Parameter(torch.zeros(d, dtype=t))
        self.norm2 = nn.LayerNorm(d, eps=cfg.ln_eps, dtype=t)
        self.fc1 = nn.Linear(d, 4 * d, dtype=t)
        self.fc2 = nn.Linear(4 * d, d, dtype=t)


class _SimpleTrunk(nn.Module):
    """The reference's ``SimpleTransformer`` stack (imagebind_extractor.py
    :1005-1123): pre-norm blocks of torch MultiheadAttention semantics,
    with ``bias_kv`` a learned k / v vector appended as one more position
    every query attends (audio / depth / thermal / IMU), ``causal`` masking
    (text), a GELU MLP, and no trunk-final LayerNorm."""

    def __init__(self, cfg: ViTConfig, causal: bool = False, bias_kv: bool = False) -> None:
        super().__init__()
        self.cfg, self.causal, self.bias_kv = cfg, causal, bias_kv
        self.blocks = nn.ModuleList([_SimpleBlock(cfg, bias_kv) for _ in range(cfg.depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, d = x.shape
        nh, hd = c.num_heads, d // c.num_heads
        mask = None
        if self.causal:
            mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
            if self.bias_kv:   # the appended bias position is attendable from every query
                mask = torch.cat([mask, mask.new_ones((t, 1))], dim=1)

        def heads(z):
            return z.reshape(b, -1, nh, hd).transpose(1, 2)

        for blk in self.blocks:
            q, k, v = (heads(z) for z in blk.qkv(blk.norm1(x)).split(d, dim=-1))
            if self.bias_kv:
                k = torch.cat([k, blk.bias_k.reshape(1, nh, 1, hd).expand(b, -1, -1, -1)], 2)
                v = torch.cat([v, blk.bias_v.reshape(1, nh, 1, hd).expand(b, -1, -1, -1)], 2)
            s = torch.einsum("bhqd,bhkd->bhqk", q * hd ** -0.5, k).float()
            if mask is not None:
                s = s.masked_fill(~mask, float("-inf"))
            a = torch.softmax(s, dim=-1).to(c.dtype)
            o = torch.einsum("bhqk,bhkd->bhqd", a, v).transpose(1, 2).reshape(b, t, d)
            x = x + blk.proj(o)
            x = x + blk.fc2(F.gelu(blk.fc1(blk.norm2(x))))
        return x


class _PatchTrunk(nn.Module):
    """A patch tower: the stem (a bias-free conv for audio / depth / thermal,
    [B, H, W] or [B, H, W, 1]; linear patches of ``kernel`` samples for
    IMU, [B, 6, T]), the stem LayerNorm (eps 1e-5), CLS, a learned position
    embedding, the bias_kv trunk, then LN -> CLS -> Linear -> L2."""

    def __init__(self, embed_dim: int, depth: int, heads: int, out_dim: int = 1024,
                 kernel: int = 16, stride: Optional[int] = None,
                 in_hw: tuple = (128, 204), mode: str = "conv2d", dtype=torch.float32, *,
                 n_tokens: Optional[int] = None) -> None:
        super().__init__()
        self.embed_dim, self.kernel, self.mode, self.dtype = embed_dim, kernel, mode, dtype
        s = stride or kernel
        if mode == "conv2d":
            self.stem = Conv2d(1, embed_dim, kernel, s, bias=False, dtype=dtype)
            t = ((in_hw[0] - kernel) // s + 1) * ((in_hw[1] - kernel) // s + 1)
        else:   # IMU's [6, 2000] windows unless n_tokens says otherwise
            self.stem = nn.Linear(6 * kernel, embed_dim, bias=False, dtype=dtype)
            t = 2000 // kernel
        t = n_tokens if n_tokens is not None else t
        self.stem_norm = nn.LayerNorm(embed_dim, eps=1e-5, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim, dtype=dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, t + 1, embed_dim, dtype=dtype))
        self.trunk = _SimpleTrunk(_block_cfg(embed_dim, depth, heads, dtype), bias_kv=True)
        self.head_norm = nn.LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = nn.Linear(embed_dim, out_dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = x.to(self.dtype)
        if self.mode == "conv2d":
            if x.dim() == 3:
                x = x[..., None]
            x = self.stem(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        else:
            k = self.kernel
            bt = x.shape[-1] // k
            x = x[:, :, :bt * k].reshape(b, x.shape[1], bt, k).transpose(1, 2).reshape(b, bt, -1)
            x = self.stem(x)
        x = self.stem_norm(x)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1) + self.pos_embed
        x = self.trunk(x)
        return l2_normalize(self.head(self.head_norm(x[:, 0])).float())


class ImageBindText(nn.Module):
    """Token ids [B, T] -> the causal trunk -> the EOT token (highest id) ->
    LN -> Linear -> L2 (SelectEOSAndProject, reference :116-130,:1473-1478)."""

    def __init__(self, vocab: int = 49408, context: int = 77, embed_dim: int = 1024,
                 depth: int = 24, heads: int = 16, out_dim: int = 1024,
                 dtype=torch.float32) -> None:
        super().__init__()
        self.context, self.dtype = context, dtype
        self.token_embedding = nn.Embedding(vocab, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, context, embed_dim))
        self.trunk = _SimpleTrunk(_block_cfg(embed_dim, depth, heads, dtype), causal=True)
        self.head_norm = nn.LayerNorm(embed_dim, eps=1e-6, dtype=dtype)
        self.head = nn.Linear(embed_dim, out_dim, bias=False, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        tokens = tokens.long()
        x = (self.token_embedding(tokens) + self.pos_embed[:, :t]).to(self.dtype)
        x = self.trunk(x)
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return l2_normalize(self.head(self.head_norm(pooled)).float())


def log_mel_spectrogram(
    waveform: np.ndarray, sample_rate: int = 16000, num_mel_bins: int = 128,
    target_len: int = 204, frame_ms: float = 25.0, shift_ms: float = 10.0,
) -> np.ndarray:
    """Minimal log-mel fbank (torchaudio-kaldi-style shape semantics:
    [mel, frames] padded / cropped to ``target_len`` frames), numpy on the
    host; the JAX package's own, copied."""
    win = int(sample_rate * frame_ms / 1000)
    hop = int(sample_rate * shift_ms / 1000)
    n_fft = 1 << (win - 1).bit_length()
    frames = []
    w = np.hanning(win).astype(np.float32)
    for s in range(0, max(len(waveform) - win, 1), hop):
        seg = waveform[s:s + win]
        if len(seg) < win:
            seg = np.pad(seg, (0, win - len(seg)))
        frames.append(np.abs(np.fft.rfft(seg * w, n_fft)) ** 2)
    spec = np.stack(frames, 1)   # [n_fft/2+1, T]

    def hz2mel(f):
        return 2595 * np.log10(1 + f / 700)

    def mel2hz(m):
        return 700 * (10 ** (m / 2595) - 1)

    mels = np.linspace(hz2mel(0), hz2mel(sample_rate / 2), num_mel_bins + 2)
    bins = np.floor((n_fft + 1) * mel2hz(mels) / sample_rate).astype(int)
    fb = np.zeros((num_mel_bins, spec.shape[0]), np.float32)
    for m in range(num_mel_bins):
        lo, ce, hi = bins[m], bins[m + 1], bins[m + 2]
        if ce > lo:
            fb[m, lo:ce] = (np.arange(lo, ce) - lo) / (ce - lo)
        if hi > ce:
            fb[m, ce:hi] = (hi - np.arange(ce, hi)) / (hi - ce)
    mel = np.log(fb @ spec + 1e-10)
    if mel.shape[1] < target_len:
        mel = np.pad(mel, ((0, 0), (0, target_len - mel.shape[1])))
    return mel[:, :target_len].astype(np.float32)


class ImageBindModel:
    """The multimodal embedder on ``device`` (None: the card):
    ``model({modality: batch})`` -> {modality: [B, 1024]}, L2-normalized
    then multiplied by the modality's logit scale (the reference's forward
    contract, imagebind_extractor.py:1125+, postprocessors :1506-1530), so
    only vision comes back unit-norm. Text takes strings (tokenized by
    CLIP's ``SimpleTokenizer``) or id arrays. ``checkpoint`` is a local
    ImageBind ``.pth``; None means random towers from ``seed``."""

    def __init__(self, checkpoint: Optional[str] = None, dtype=torch.float32, seed: int = 42,
                 bpe_path: Optional[str] = None, allow_hash_tokenizer: bool = False, *,
                 device: Union[None, str, torch.device] = None) -> None:
        from anyloc_tpu_torch.models.clip import SimpleTokenizer

        self.dtype, self.seed = dtype, seed
        self.device = resolve_device(device)
        sd = None
        if checkpoint is not None:
            from anyloc_tpu_torch.models.convert import load_torch_checkpoint

            sd = load_torch_checkpoint(checkpoint)
        vision_cfg = imagebind_vision_config(dtype=dtype)
        self.vision = ImageBindVision(
            dtype=dtype, seed=seed, device=self.device,
            params=None if sd is None else convert_imagebind_vision(sd, vision_cfg),
            head=None if sd is None else convert_imagebind_vision_head(sd))
        towers = {
            ModalityType.TEXT: (lambda: ImageBindText(dtype=dtype),
                                lambda: convert_imagebind_text(sd)),
            ModalityType.AUDIO: (lambda: _PatchTrunk(768, 12, 12, kernel=16, stride=10,
                                                     in_hw=(128, 204), dtype=dtype), None),
            ModalityType.DEPTH: (lambda: _PatchTrunk(768, 12, 12, kernel=16, in_hw=(224, 224),
                                                     dtype=dtype), None),
            ModalityType.THERMAL: (lambda: _PatchTrunk(768, 12, 12, kernel=16,
                                                       in_hw=(224, 224), dtype=dtype), None),
            ModalityType.IMU: (lambda: _PatchTrunk(512, 6, 8, kernel=8, mode="linear1d",
                                                   dtype=dtype), None),
        }
        for i, (m, (make, convert)) in enumerate(towers.items()):
            state = None if sd is None else (convert or (
                lambda m=m: convert_imagebind_patch(sd, m)))()
            setattr(self, m, materialize(make, state, self.device, seed=seed + 2 + i))
        self.tokenizer = SimpleTokenizer(bpe_path, allow_hash_fallback=allow_hash_tokenizer)
        self.logit_scales: Dict[str, float] = {
            ModalityType.VISION: 1.0,
            ModalityType.TEXT: min(1.0 / 0.07, 100.0),
            ModalityType.AUDIO: 20.0,
            ModalityType.DEPTH: 5.0,
            ModalityType.THERMAL: 10.0,
            ModalityType.IMU: 5.0,
        }
        ts = None if sd is None else sd.get("modality_postprocessors.text.1.log_logit_scale")
        if ts is not None:
            self.logit_scales[ModalityType.TEXT] = min(float(np.exp(np.asarray(ts))), 100.0)

    def to(self, device) -> "ImageBindModel":
        """Every tower, with its weights, onto ``device``."""
        self.device = self.vision.device = torch.device(device)
        v = self.vision
        v.model.to(self.device)
        v.head_ln = {k: t.to(self.device) for k, t in v.head_ln.items()}
        v.head_w = v.head_w.to(self.device)
        for m in _PATCH_MODALITY_SPECS.keys() | {ModalityType.TEXT}:
            getattr(self, m).to(self.device)
        return self

    @torch.inference_mode()
    def __call__(self, inputs: Dict[str, object]) -> Dict[str, torch.Tensor]:
        out = {}
        for modality, batch in inputs.items():
            if modality == ModalityType.TEXT and not isinstance(batch, (np.ndarray, torch.Tensor)):
                batch = self.tokenizer.tokenize(batch, self.text.context)
            if isinstance(batch, np.ndarray):
                batch = torch.from_numpy(batch)
            batch = batch.to(self.device)
            if modality == ModalityType.VISION:
                emb = self.vision(batch)["cls"]
            else:
                emb = getattr(self, modality)(batch)
            out[modality] = emb * self.logit_scales.get(modality, 1.0)
        return out


def _convert_simple_trunk(sd: Dict, prefix: str, depth: int, bias_kv: bool) -> Dict:
    """``modality_trunks.{m}.blocks.{i}`` (MultiheadAttention in_proj /
    out_proj, norm_1 / norm_2, mlp.fc1 / fc2) -> ``_SimpleTrunk``'s names."""
    out: Dict = {}
    for i in range(depth):
        h, b = f"{prefix}.blocks.{i}", f"blocks.{i}"
        out[f"{b}.qkv.weight"] = t2np(sd[f"{h}.attn.in_proj_weight"])
        out[f"{b}.qkv.bias"] = t2np(sd[f"{h}.attn.in_proj_bias"])
        for ours, theirs in (("norm1", "norm_1"), ("norm2", "norm_2"), ("proj", "attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            for kind in ("weight", "bias"):
                out[f"{b}.{ours}.{kind}"] = t2np(sd[f"{h}.{theirs}.{kind}"])
        if bias_kv:
            out[f"{b}.bias_k"] = t2np(sd[f"{h}.attn.bias_k"]).reshape(-1)
            out[f"{b}.bias_v"] = t2np(sd[f"{h}.attn.bias_v"]).reshape(-1)
    return out


def convert_imagebind_text(sd: Dict, depth: int = 24) -> Dict[str, torch.Tensor]:
    """The text tower (``modality_preprocessors.text`` token and position
    embeddings, the causal trunk, ``modality_heads.text.proj`` LN + Linear)
    -> ``ImageBindText``'s state dict."""
    pre = "modality_preprocessors.text."
    out = {"token_embedding.weight": t2np(sd[f"{pre}token_embedding.weight"]),
           "pos_embed": t2np(sd[f"{pre}pos_embed"]),
           "head_norm.weight": t2np(sd["modality_heads.text.proj.0.weight"]),
           "head_norm.bias": t2np(sd["modality_heads.text.proj.0.bias"]),
           "head.weight": t2np(sd["modality_heads.text.proj.1.weight"])}
    trunk = _convert_simple_trunk(sd, "modality_trunks.text", depth, bias_kv=False)
    out.update({f"trunk.{k}": v for k, v in trunk.items()})
    return tensors(out)


# (stem key, trunk depth, head Sequential index of the Linear: imu has a
# Dropout at index 2, reference :1480-1502)
_PATCH_MODALITY_SPECS = {
    ModalityType.AUDIO: ("rgbt_stem", 12, 2),
    ModalityType.DEPTH: ("depth_stem", 12, 2),
    ModalityType.THERMAL: ("rgbt_stem", 12, 2),
    ModalityType.IMU: ("imu_stem", 6, 3),
}


def convert_imagebind_patch(sd: Dict, modality: str, depth: Optional[int] = None
                            ) -> Dict[str, torch.Tensor]:
    """The audio / depth / thermal / IMU tower -> ``_PatchTrunk``'s state
    dict: the stem (a Conv2d [D, 1, k, k], under ``rgbt_stem`` for audio and
    thermal, reference :483-490,:727-735; IMU a Linear [D, 48]) and its
    norm, CLS, the position embedding, the bias_kv trunk, LN -> Linear."""
    stem, default_depth, head_idx = _PATCH_MODALITY_SPECS[modality]
    depth = default_depth if depth is None else depth
    pre = f"modality_preprocessors.{modality}."
    pos = f"{pre}pos_embed" if modality == ModalityType.IMU else \
        f"{pre}pos_embedding_helper.pos_embed"
    out = {"cls_token": t2np(sd[f"{pre}cls_token"]),
           "stem.weight": t2np(sd[f"{pre}{stem}.proj.weight"]),
           "pos_embed": t2np(sd[pos]),
           "stem_norm.weight": t2np(sd[f"{pre}{stem}.norm_layer.weight"]),
           "stem_norm.bias": t2np(sd[f"{pre}{stem}.norm_layer.bias"]),
           "head_norm.weight": t2np(sd[f"modality_heads.{modality}.0.weight"]),
           "head_norm.bias": t2np(sd[f"modality_heads.{modality}.0.bias"]),
           "head.weight": t2np(sd[f"modality_heads.{modality}.{head_idx}.weight"])}
    trunk = _convert_simple_trunk(sd, f"modality_trunks.{modality}", depth, bias_kv=True)
    out.update({f"trunk.{k}": v for k, v in trunk.items()})
    return tensors(out)


def imagebind_huge(checkpoint: Optional[str] = None, full: bool = False, **kw):
    """Factory-name parity (imagebind_extractor.py:1567-1596): the vision
    extractor of the VPR pipeline, or with ``full=True`` the multimodal
    ``ImageBindModel``."""
    if full:
        return ImageBindModel(checkpoint, **kw)
    return ImageBindVision(checkpoint, **kw)
