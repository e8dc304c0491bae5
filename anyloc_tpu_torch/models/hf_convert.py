"""HuggingFace-layout checkpoints renamed into the original repositories'
naming (counterpart of ``anyloc_tpu/models/hf_convert.py``, numpy only).

The reference's weights come from torch.hub / the original repositories
(facebookresearch/dinov2, facebookresearch/mae, openai CLIP, Meta SAM),
and the same checkpoints are mostly redistributed in the ``transformers``
layout (facebook/dinov2-*, facebook/vit-mae-*, openai/clip-vit-*,
facebook/sam-vit-*). ``ensure_native_naming(sd, family)`` renames such a
state dict into the original naming, or returns it unchanged, so each
family's loader takes both formats (``models/dinov2.py::native_state_dict``
calls it on entry). The other families' branches are here with the file;
their loaders are ported with the families.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def t2np(t) -> np.ndarray:
    """torch.Tensor | np.ndarray -> float32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def strip_prefix(sd: Mapping, prefix: str) -> Dict:
    """Drop a wrapper prefix ('module.', 'model.', ...) from every key."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}


def _np(sd: Mapping, k: str) -> np.ndarray:
    return t2np(sd[k])


def _fuse_qkv(sd: Mapping, q: str, k: str, v: str, out: Dict, name: str):
    """HF separate q/k/v Linears -> the original fused qkv Linear.

    The fused [3D, D] torch weight stacks rows [q; k; v] (per-tensor, NOT
    per-head interleaved) — the layout the reference's facet slicing assumes
    (utilities.py:274-281 takes contiguous thirds of the qkv output).
    """
    out[f"{name}.weight"] = np.concatenate(
        [_np(sd, f"{q}.weight"), _np(sd, f"{k}.weight"), _np(sd, f"{v}.weight")], 0
    )
    if f"{q}.bias" in sd:
        out[f"{name}.bias"] = np.concatenate(
            [_np(sd, f"{q}.bias"), _np(sd, f"{k}.bias"), _np(sd, f"{v}.bias")], 0
        )


def _copy(sd: Mapping, src: str, out: Dict, dst: str, suffixes=("weight", "bias")):
    for s in suffixes:
        if f"{src}.{s}" in sd:
            out[f"{dst}.{s}"] = _np(sd, f"{src}.{s}")


# ---------------------------------------------------------------------------
# DINOv2: transformers Dinov2Model / Dinov2WithRegistersModel
#   -> facebookresearch/dinov2 naming
# ---------------------------------------------------------------------------

def hf_to_dinov2(sd: Mapping) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {
        "cls_token": _np(sd, "embeddings.cls_token"),
        "pos_embed": _np(sd, "embeddings.position_embeddings"),
    }
    _copy(sd, "embeddings.patch_embeddings.projection", out, "patch_embed.proj")
    if "embeddings.register_tokens" in sd:
        out["register_tokens"] = _np(sd, "embeddings.register_tokens")
    _copy(sd, "layernorm", out, "norm")
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        h, b = f"encoder.layer.{i}", f"blocks.{i}"
        _copy(sd, f"{h}.norm1", out, f"{b}.norm1")
        _copy(sd, f"{h}.norm2", out, f"{b}.norm2")
        _fuse_qkv(sd, f"{h}.attention.attention.query",
                  f"{h}.attention.attention.key",
                  f"{h}.attention.attention.value", out, f"{b}.attn.qkv")
        _copy(sd, f"{h}.attention.output.dense", out, f"{b}.attn.proj")
        out[f"{b}.ls1.gamma"] = _np(sd, f"{h}.layer_scale1.lambda1")
        out[f"{b}.ls2.gamma"] = _np(sd, f"{h}.layer_scale2.lambda1")
        if f"{h}.mlp.weights_in.weight" in sd:  # SwiGLU (the giant)
            _copy(sd, f"{h}.mlp.weights_in", out, f"{b}.mlp.w12")
            _copy(sd, f"{h}.mlp.weights_out", out, f"{b}.mlp.w3")
        else:
            _copy(sd, f"{h}.mlp.fc1", out, f"{b}.mlp.fc1")
            _copy(sd, f"{h}.mlp.fc2", out, f"{b}.mlp.fc2")
        i += 1
    return out


# ---------------------------------------------------------------------------
# MAE: transformers ViTMAEForPreTraining (facebook/vit-mae-*)
#   -> facebookresearch/mae naming
# ---------------------------------------------------------------------------

def _hf_vit_layer(sd: Mapping, h: str, out: Dict, b: str):
    """One HF ViT encoder layer (layernorm_before/attention/intermediate/
    output naming) -> timm-style block naming shared by MAE."""
    _copy(sd, f"{h}.layernorm_before", out, f"{b}.norm1")
    _copy(sd, f"{h}.layernorm_after", out, f"{b}.norm2")
    _fuse_qkv(sd, f"{h}.attention.attention.query",
              f"{h}.attention.attention.key",
              f"{h}.attention.attention.value", out, f"{b}.attn.qkv")
    _copy(sd, f"{h}.attention.output.dense", out, f"{b}.attn.proj")
    _copy(sd, f"{h}.intermediate.dense", out, f"{b}.mlp.fc1")
    _copy(sd, f"{h}.output.dense", out, f"{b}.mlp.fc2")


def hf_to_mae(sd: Mapping) -> Dict[str, np.ndarray]:
    """Expects the ForPreTraining layout (``vit.`` encoder + ``decoder.``) —
    the layout facebook/vit-mae-{base,large,huge} ship."""
    out: Dict[str, np.ndarray] = {
        "cls_token": _np(sd, "vit.embeddings.cls_token"),
        "mask_token": _np(sd, "decoder.mask_token"),
    }
    _copy(sd, "vit.embeddings.patch_embeddings.projection", out,
          "patch_embed.proj")
    _copy(sd, "vit.layernorm", out, "norm")
    _copy(sd, "decoder.decoder_embed", out, "decoder_embed")
    _copy(sd, "decoder.decoder_norm", out, "decoder_norm")
    _copy(sd, "decoder.decoder_pred", out, "decoder_pred")
    # (vit.embeddings.position_embeddings / decoder.decoder_pos_embed are the
    # fixed 2-D sin-cos buffers — recomputed, not loaded, like the original)
    i = 0
    while f"vit.encoder.layer.{i}.layernorm_before.weight" in sd:
        _hf_vit_layer(sd, f"vit.encoder.layer.{i}", out, f"blocks.{i}")
        i += 1
    i = 0
    while f"decoder.decoder_layers.{i}.layernorm_before.weight" in sd:
        _hf_vit_layer(sd, f"decoder.decoder_layers.{i}", out,
                      f"decoder_blocks.{i}")
        i += 1
    return out


# ---------------------------------------------------------------------------
# DINO v1: transformers ViTModel (facebook/dino-vit*) -> timm naming
# ---------------------------------------------------------------------------

def hf_to_dino_v1(sd: Mapping) -> Dict[str, np.ndarray]:
    """transformers ``ViTModel`` layout -> the timm-style naming of the
    original facebookresearch/dino checkpoints (what ``convert_dino_v1``
    consumes).  The pooler head, if present, is dropped."""
    out: Dict[str, np.ndarray] = {
        "cls_token": _np(sd, "embeddings.cls_token"),
        "pos_embed": _np(sd, "embeddings.position_embeddings"),
    }
    _copy(sd, "embeddings.patch_embeddings.projection", out, "patch_embed.proj")
    _copy(sd, "layernorm", out, "norm")
    i = 0
    while f"encoder.layer.{i}.layernorm_before.weight" in sd:
        _hf_vit_layer(sd, f"encoder.layer.{i}", out, f"blocks.{i}")
        i += 1
    return out


# ---------------------------------------------------------------------------
# CLIP: transformers CLIPModel (openai/clip-vit-*) -> OpenAI CLIP naming
# ---------------------------------------------------------------------------

def _hf_clip_layer(sd: Mapping, h: str, out: Dict, b: str):
    _copy(sd, f"{h}.layer_norm1", out, f"{b}.ln_1")
    _copy(sd, f"{h}.layer_norm2", out, f"{b}.ln_2")
    _fuse_qkv(sd, f"{h}.self_attn.q_proj", f"{h}.self_attn.k_proj",
              f"{h}.self_attn.v_proj", out, f"{b}.attn.in_proj")
    # OpenAI uses nn.MultiheadAttention's in_proj_weight/in_proj_bias names
    if f"{b}.attn.in_proj.weight" in out:
        out[f"{b}.attn.in_proj_weight"] = out.pop(f"{b}.attn.in_proj.weight")
    if f"{b}.attn.in_proj.bias" in out:
        out[f"{b}.attn.in_proj_bias"] = out.pop(f"{b}.attn.in_proj.bias")
    _copy(sd, f"{h}.self_attn.out_proj", out, f"{b}.attn.out_proj")
    _copy(sd, f"{h}.mlp.fc1", out, f"{b}.mlp.c_fc")
    _copy(sd, f"{h}.mlp.fc2", out, f"{b}.mlp.c_proj")


def hf_to_clip(sd: Mapping) -> Dict[str, np.ndarray]:
    """Full-model HF CLIP -> OpenAI naming.  Tolerates vision-only exports
    (``CLIPVisionModel`` layout: no text tower / projections / logit_scale) —
    the vision keys convert and the text-side keys are simply absent, so
    ``convert_clip_vision`` works standalone on such checkpoints."""
    out: Dict[str, np.ndarray] = {
        "visual.class_embedding": _np(sd, "vision_model.embeddings.class_embedding"),
        "visual.conv1.weight": _np(sd, "vision_model.embeddings.patch_embedding.weight"),
        "visual.positional_embedding": _np(
            sd, "vision_model.embeddings.position_embedding.weight"),
    }
    # projections: HF Linear(bias=False) weight [out, in] -> OpenAI raw
    # parameter [in, out] applied as x @ proj
    if "visual_projection.weight" in sd:
        out["visual.proj"] = _np(sd, "visual_projection.weight").T
    if "text_projection.weight" in sd:
        out["text_projection"] = _np(sd, "text_projection.weight").T
    if "logit_scale" in sd:
        out["logit_scale"] = _np(sd, "logit_scale")
    if "text_model.embeddings.token_embedding.weight" in sd:
        out["token_embedding.weight"] = _np(
            sd, "text_model.embeddings.token_embedding.weight")
        out["positional_embedding"] = _np(
            sd, "text_model.embeddings.position_embedding.weight")
    # "pre_layrnorm" is the historical transformers typo; newer versions may
    # spell it correctly — accept both
    pre = ("vision_model.pre_layrnorm"
           if "vision_model.pre_layrnorm.weight" in sd
           else "vision_model.pre_layernorm")
    _copy(sd, pre, out, "visual.ln_pre")
    _copy(sd, "vision_model.post_layernorm", out, "visual.ln_post")
    if "text_model.final_layer_norm.weight" in sd:
        _copy(sd, "text_model.final_layer_norm", out, "ln_final")
    i = 0
    while f"vision_model.encoder.layers.{i}.layer_norm1.weight" in sd:
        _hf_clip_layer(sd, f"vision_model.encoder.layers.{i}", out,
                       f"visual.transformer.resblocks.{i}")
        i += 1
    i = 0
    while f"text_model.encoder.layers.{i}.layer_norm1.weight" in sd:
        _hf_clip_layer(sd, f"text_model.encoder.layers.{i}", out,
                       f"transformer.resblocks.{i}")
        i += 1
    return out


# ---------------------------------------------------------------------------
# SAM: transformers SamModel (facebook/sam-vit-*) -> Meta SAM naming
# ---------------------------------------------------------------------------

def hf_to_sam(sd: Mapping) -> Dict[str, np.ndarray]:
    pre = "vision_encoder."
    out: Dict[str, np.ndarray] = {
        "image_encoder.pos_embed": _np(sd, f"{pre}pos_embed"),
    }
    _copy(sd, f"{pre}patch_embed.projection", out, "image_encoder.patch_embed.proj")
    # Meta's neck is an nn.Sequential: 0=conv1x1, 1=LayerNorm2d, 2=conv3x3, 3=LayerNorm2d
    _copy(sd, f"{pre}neck.conv1", out, "image_encoder.neck.0")
    _copy(sd, f"{pre}neck.layer_norm1", out, "image_encoder.neck.1")
    _copy(sd, f"{pre}neck.conv2", out, "image_encoder.neck.2")
    _copy(sd, f"{pre}neck.layer_norm2", out, "image_encoder.neck.3")
    i = 0
    while f"{pre}layers.{i}.layer_norm1.weight" in sd:
        h, b = f"{pre}layers.{i}", f"image_encoder.blocks.{i}"
        _copy(sd, f"{h}.layer_norm1", out, f"{b}.norm1")
        _copy(sd, f"{h}.layer_norm2", out, f"{b}.norm2")
        _copy(sd, f"{h}.attn.qkv", out, f"{b}.attn.qkv")
        _copy(sd, f"{h}.attn.proj", out, f"{b}.attn.proj")
        if f"{h}.attn.rel_pos_h" in sd:
            out[f"{b}.attn.rel_pos_h"] = _np(sd, f"{h}.attn.rel_pos_h")
            out[f"{b}.attn.rel_pos_w"] = _np(sd, f"{h}.attn.rel_pos_w")
        _copy(sd, f"{h}.mlp.lin1", out, f"{b}.mlp.lin1")
        _copy(sd, f"{h}.mlp.lin2", out, f"{b}.mlp.lin2")
        i += 1
    return out


# ---------------------------------------------------------------------------
# Detection / dispatch
# ---------------------------------------------------------------------------

_SIGNATURES = {
    # (keys that must ALL be present in the HF layout of that family) ->
    # renamer.  dinov2 and dino_v1 share the embeddings signature, so each
    # also requires a block-level key unique to its layer layout.
    "dinov2": (("embeddings.patch_embeddings.projection.weight",
                "encoder.layer.0.layer_scale1.lambda1"), hf_to_dinov2),
    "dino_v1": (("embeddings.patch_embeddings.projection.weight",
                 "encoder.layer.0.layernorm_before.weight"), hf_to_dino_v1),
    "mae": (("vit.embeddings.patch_embeddings.projection.weight",), hf_to_mae),
    "clip": (("vision_model.embeddings.patch_embedding.weight",), hf_to_clip),
    "sam": (("vision_encoder.patch_embed.projection.weight",), hf_to_sam),
}


def ensure_native_naming(sd: Mapping, family: str) -> Mapping:
    """If ``sd`` is in the HF layout for ``family``, rename it to the
    original-repo naming; otherwise return it unchanged.  Called at the top
    of each family's converter so both formats load transparently."""
    sigs, fn = _SIGNATURES[family]
    # HF checkpoints sometimes carry a top-level "model." prefix (e.g. when
    # exported from a wrapper); probe both
    if all(s in sd for s in sigs):
        return fn(sd)
    if all(f"model.{s}" in sd for s in sigs):
        return fn(strip_prefix(sd, "model."))
    return sd
