"""CLIP (OpenAI / OpenCLIP): the image and text towers and the
``ClipWrapper`` API (counterpart of ``anyloc_tpu/models/clip.py``; the
reference's backend wrapper, clip_wrapper.py:51-451).

* The vision tower is the shared ViT trunk configured CLIP-style:
  ``norm_pre``, quick-GELU for OpenAI models, a bias-free patch conv, a
  learned position embedding with CLS (resized to the grid's size), the
  final LayerNorm and ``proj_out`` into the joint space. The CLIP
  pipelines run it in float32, so K5 runs in f32 at 577 tokens for
  ViT-L/14@336px.
* The text tower is a causal pre-LN transformer with EOT pooling and a
  text projection, with plain attention as in the JAX package; its module
  names are OpenAI's, so an OpenAI state dict's text keys load unchanged.
* ``ClipWrapper`` keeps the reference's ``encode_image`` /
  ``encode_text`` / zero-shot ``__call__`` / ``load`` / ``list_models``
  and the per-item ``.npz`` descriptor caches.

Tokenization: ``SimpleTokenizer`` is CLIP's BPE over a
``bpe_simple_vocab_16e6.txt.gz`` merges file. The JAX package splits the
text with the ``regex`` module's ``\\p{L}`` / ``\\p{N}`` classes; this one
scans it with ``unicodedata`` categories (``split_words``) and needs no
package beyond the standard library. Without a merges file it refuses to
encode unless the hash fallback is asked for (``allow_hash_fallback``).
"""

from __future__ import annotations

import gzip
import hashlib
import os
import unicodedata
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from anyloc_tpu_torch.models.convert import (from_jax_params, materialize, maybe_tp_split,
                                             t2np, tensors)
from anyloc_tpu_torch.models.hf_convert import ensure_native_naming
from anyloc_tpu_torch.models.vit import ACTIVATIONS, ViT, ViTConfig
from anyloc_tpu_torch.ops.common import l2_normalize, resolve_device

# name: (patch, width, layers, heads, embed_dim, image_size)
_VISION = {
    "ViT-B/32": (32, 768, 12, 12, 512, 224),
    "ViT-B/16": (16, 768, 12, 12, 512, 224),
    "ViT-L/14": (14, 1024, 24, 16, 768, 224),
    "ViT-L/14@336px": (14, 1024, 24, 16, 768, 336),
}
# text: (context, vocab, width, heads, layers); embed_dim from the vision tower
_TEXT = {
    "ViT-B/32": (77, 49408, 512, 8, 12),
    "ViT-B/16": (77, 49408, 512, 8, 12),
    "ViT-L/14": (77, 49408, 768, 12, 12),
    "ViT-L/14@336px": (77, 49408, 768, 12, 12),
}


def clip_vision_config(name: str, dtype=None, quick: bool = True) -> ViTConfig:
    p, w, layers, heads, embed, img = _VISION[name]
    kwargs = dict(
        img_size=img, patch_size=p, embed_dim=w, depth=layers, num_heads=heads,
        mlp_type="mlp", act="quick_gelu" if quick else "gelu", layerscale_init=None,
        ln_eps=1e-5, pre_norm=True, patch_bias=False, proj_dim=embed,
        interpolate_offset=0.0,
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    return ViTConfig(**kwargs)


class _TextAttention(nn.Module):
    def __init__(self, width: int) -> None:
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class _TextMlp(nn.Module):
    def __init__(self, width: int) -> None:
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)


class _TextBlock(nn.Module):
    def __init__(self, width: int) -> None:
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _TextAttention(width)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _TextMlp(width)


class CLIPTextTower(nn.Module):
    """Causal text transformer with EOT pooling (OpenAI CLIP's layout and
    names), float32, plain attention: tokens [B, T] int -> [B, embed_dim]."""

    def __init__(self, vocab: int = 49408, width: int = 512, heads: int = 8,
                 layers: int = 12, context: int = 77, embed_dim: int = 512,
                 quick: bool = True) -> None:
        super().__init__()
        self.heads = heads
        self.act = ACTIVATIONS["quick_gelu" if quick else "gelu"]
        # no default init (the weights are loaded or drawn by ``materialize``):
        # nn.Embedding's normal_ on the meta device imports torch._dynamo, ~8 s
        self.token_embedding = nn.Embedding(vocab, width, _weight=torch.empty(vocab, width))
        self.positional_embedding = nn.Parameter(torch.empty(context, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([_TextBlock(width) for _ in range(layers)])
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        w = x.shape[-1]
        hd = w // self.heads
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        for blk in self.transformer.resblocks:
            h = blk.ln_1(x)
            qkv = F.linear(h, blk.attn.in_proj_weight, blk.attn.in_proj_bias)
            q, k, v = (qkv[..., i * w:(i + 1) * w].reshape(b, t, self.heads, hd).transpose(1, 2)
                       for i in range(3))
            s = (q * hd ** -0.5) @ k.transpose(-1, -2)
            a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            o = (a @ v).transpose(1, 2).reshape(b, t, w)
            x = x + blk.attn.out_proj(o)
            x = x + blk.mlp.c_proj(self.act(blk.mlp.c_fc(blk.ln_2(x))))
        x = self.ln_final(x)
        # EOT pooling: the highest token id marks the end of the text
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
        return pooled @ self.text_projection


# ---------------------------------------------------------------------------
# Converters (OpenAI CLIP state-dict naming)
# ---------------------------------------------------------------------------

def convert_clip_vision(sd: Dict, cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """An OpenAI (or HuggingFace ``CLIPModel``) state dict -> the vision
    trunk's state dict: ``in_proj`` is the fused qkv (q|k|v rows),
    ``visual.proj`` [D, embed] the transposed ``proj_out``."""
    sd = ensure_native_naming(sd, "clip")
    pre = "visual."
    out = {
        "patch_embed.proj.weight": t2np(sd[pre + "conv1.weight"]),
        "cls_token": t2np(sd[pre + "class_embedding"]).reshape(1, 1, -1),
        "pos_embed": t2np(sd[pre + "positional_embedding"])[None],
        "proj_out.weight": t2np(sd[pre + "proj"]).T,
    }
    for ours, theirs in (("norm_pre", "ln_pre"), ("norm", "ln_post")):
        for kind in ("weight", "bias"):
            out[f"{ours}.{kind}"] = sd[f"{pre}{theirs}.{kind}"]
    for i in range(cfg.depth):
        h, b = f"{pre}transformer.resblocks.{i}", f"blocks.{i}"
        out[f"{b}.attn.qkv.weight"] = sd[f"{h}.attn.in_proj_weight"]
        out[f"{b}.attn.qkv.bias"] = sd[f"{h}.attn.in_proj_bias"]
        for ours, theirs in (("norm1", "ln_1"), ("norm2", "ln_2"), ("attn.proj", "attn.out_proj"),
                             ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            for kind in ("weight", "bias"):
                out[f"{b}.{ours}.{kind}"] = sd[f"{h}.{theirs}.{kind}"]
    return maybe_tp_split(tensors({k: t2np(v) for k, v in out.items()}), cfg)


def convert_clip_text(sd: Dict, layers: int) -> Dict[str, torch.Tensor]:
    """An OpenAI (or HuggingFace ``CLIPModel``) state dict -> the text
    tower's state dict (OpenAI's names: the text keys of ``layers``
    blocks)."""
    sd = ensure_native_naming(sd, "clip")
    keep = ("token_embedding.", "positional_embedding", "ln_final.", "text_projection")
    blocks = tuple(f"transformer.resblocks.{i}." for i in range(layers))
    return tensors({k: t2np(v) for k, v in sd.items() if k.startswith(keep + blocks)})


def _text_rename(key: str, arr: np.ndarray):
    """The JAX text tower's flat names -> OpenAI's."""
    name, _, rest = key.partition(".")
    if name == "text_projection":   # a Dense kernel [width, embed] used as x @ P
        return name, arr.T
    if name == "positional_embedding" or name in ("token_embedding", "ln_final"):
        return key, arr
    i, _, kind = rest.partition(".")
    b = f"transformer.resblocks.{i}"
    if name == "attn_qkv":
        return f"{b}.attn.in_proj_{kind}", arr
    return f"{b}." + {"ln1": "ln_1", "ln2": "ln_2", "attn_proj": "attn.out_proj",
                      "mlp_fc": "mlp.c_fc", "mlp_proj": "mlp.c_proj"}[name] + f".{kind}", arr


def from_jax_text_params(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``CLIPTextTower`` tree -> the port's state dict."""
    return from_jax_params(params, _text_rename)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# U+0345 (combining ypogegrammeni, category Mn) folds to a letter (iota): the
# JAX package's case-insensitive classes take it for neither a letter nor a
# non-letter, so its pattern matches no word there and skips it
_SKIPPED = frozenset("ͅ")


def _kind(ch: str) -> str:
    """"L" (a letter: categories L*), "N" (a number: N*), " " (white space
    or skipped) or "O" (anything else)."""
    if ch.isspace() or ch in _SKIPPED:
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else "O"


def _match_folded(text: str, i: int, word: str) -> bool:
    """``word`` (lowercase ASCII) at ``text[i:]``, case-insensitively as
    the JAX pattern's IGNORECASE compares (simple case folding: "ſ" is "s")."""
    part = text[i:i + len(word)]
    return len(part) == len(word) and all(a.casefold() == b for a, b in zip(part, word))


def split_words(text: str) -> List[str]:
    """CLIP's word split, the JAX package's pattern
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    (case-insensitive) as a left-to-right scan: at each position the first
    alternative that matches, letters and other characters in maximal runs,
    numbers one by one; white space separates. Letters and numbers are
    ``unicodedata``'s categories L* and N* (Python's Unicode tables)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        word = next((w for w in _SPECIALS + _CONTRACTIONS if _match_folded(text, i, w)), None)
        if word is not None:
            out.append(text[i:i + len(word)])
            i += len(word)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    """CLIP's BPE tokenizer (the reference's vendored simple_tokenizer,
    imagebind_extractor.py:285-336,790-850) over the standard
    ``bpe_simple_vocab_16e6.txt.gz`` merges file.

    Without a merges file it refuses to encode unless constructed with
    ``allow_hash_fallback=True``: the hash fallback's ids are stable but
    meaningless (cache keys and shape tests only, never real prompts).
    Search order when ``bpe_path`` is None: $ANYLOC_CLIP_BPE, then
    ``~/.cache/clip/`` and ``~/.cache/anyloc_tpu/``."""

    SOT, EOT = 49406, 49407   # class-level defaults (the full CLIP vocabulary)
    _STD_NAME = "bpe_simple_vocab_16e6.txt.gz"

    def __init__(self, bpe_path: Optional[str] = None, vocab: int = 49408,
                 allow_hash_fallback: bool = False) -> None:
        self.bpe = None
        self.vocab = vocab
        self.allow_hash_fallback = allow_hash_fallback
        # the standard special ids, clamped into range for smaller vocabularies
        self.SOT = min(49406, vocab - 2)
        self.EOT = min(49407, vocab - 1)
        if bpe_path is None:
            bpe_path = self._find_standard_path()
        if bpe_path and os.path.exists(bpe_path):
            self._load_bpe(bpe_path)

    @classmethod
    def _find_standard_path(cls) -> Optional[str]:
        cands = [os.environ.get("ANYLOC_CLIP_BPE")]
        for d in ("~/.cache/clip", "~/.cache/anyloc_tpu"):
            cands.append(os.path.join(os.path.expanduser(d), cls._STD_NAME))
        return next((c for c in cands if c and os.path.exists(c)), None)

    def _load_bpe(self, path: str) -> None:
        with (gzip.open(path) if path.endswith(".gz") else open(path, "rb")) as f:
            raw = f.read()
        lines = raw.decode("utf-8").split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in lines]
        merges = [m for m in merges if len(m) == 2]   # blank tail lines drop
        self.byte_encoder = self._bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        if len(vocab) > self.vocab:
            # ids past this text tower's embedding table would index out of
            # it: refuse the file, so that encode() raises (or hashes, if
            # asked), keeping the clamped special ids
            import warnings

            warnings.warn(
                f"BPE merges at {path} define {len(vocab)} ids but this tokenizer's vocab "
                f"is {self.vocab}; ignoring the file (use the full 49408-id text tower "
                "for real BPE).")
            return
        self.encoder = {v: i for i, v in enumerate(vocab)}
        # the specials end the BPE vocabulary (49406 / 49407 only for the
        # full 49152-merge file)
        self.SOT = self.encoder["<|startoftext|>"]
        self.EOT = self.encoder["<|endoftext|>"]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.bpe = True

    @staticmethod
    def _bytes_to_unicode() -> Dict[int, str]:
        """GPT-2 / CLIP's byte -> unicode table: printable bytes map to
        themselves, the others to chr(256 + n)."""
        bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
              + list(range(ord("\xae"), ord("\xff") + 1)))
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        return dict(zip(bs, (chr(c) for c in cs)))

    def _bpe_word(self, token: str) -> List[str]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e18))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        return list(word)

    @staticmethod
    def _clean(text: str) -> str:
        """CLIP's whitespace_clean and basic_clean without ftfy: HTML
        unescape twice, collapse white space, strip, lowercase."""
        import html
        import re

        text = html.unescape(html.unescape(text))
        return re.sub(r"\s+", " ", text).strip().lower()

    def encode(self, text: str) -> List[int]:
        if self.bpe:
            out = []
            for tok in split_words(self._clean(text)):
                # UTF-8 bytes -> the surrogate characters, then BPE
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                out.extend(self.encoder[u] for u in self._bpe_word(tok))
            return out
        if not self.allow_hash_fallback:
            raise RuntimeError(
                "No BPE merges file found — real CLIP tokenization needs "
                f"'{self._STD_NAME}' (set $ANYLOC_CLIP_BPE or place it under "
                "~/.cache/clip/). Pass allow_hash_fallback=True only for "
                "cache-key/shape work: hash ids are NOT CLIP token ids.")
        # the hash fallback: one id per white-space word, in [1, SOT)
        hi = max(self.SOT - 1, 2)
        return [int.from_bytes(hashlib.sha1(w.encode()).digest()[:3], "little") % (hi - 1) + 1
                for w in text.lower().strip().split()]

    def tokenize(self, texts, context_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.SOT] + self.encode(t)[:context_length - 2] + [self.EOT]
            out[i, :len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# ClipWrapper (the reference's clip_wrapper.py API)
# ---------------------------------------------------------------------------

class ClipWrapper:
    """The reference's CLIP wrapper on ``device`` (None: the card).
    ``checkpoint`` is a local OpenAI ``.pt`` state dict; None means random
    towers from ``seed`` (and logit scale 100)."""

    IMPL_OPENAI = "openai"
    IMPL_OPEN_CLIP = "open_clip"

    def __init__(self, impl: str, name: str, pretrained: Optional[str] = None,
                 prep_apply: bool = True, use_caching=True, base_cache_dir: Optional[str] = None,
                 save_norm_descs: bool = True, checkpoint: Optional[str] = None,
                 bpe_path: Optional[str] = None, allow_hash_tokenizer: bool = False,
                 dtype=torch.float32, seed: int = 42,
                 device: Union[None, str, torch.device] = None) -> None:
        if impl not in (self.IMPL_OPENAI, self.IMPL_OPEN_CLIP):
            raise ValueError(f"unknown CLIP implementation {impl!r}")
        self.impl, self.name, self.pretrained = impl, name, pretrained
        self.prep_apply = prep_apply
        self.save_norm_descs = save_norm_descs
        self.device = resolve_device(device)
        quick = impl == self.IMPL_OPENAI or "quickgelu" in name
        canonical = name
        if impl == self.IMPL_OPEN_CLIP and name not in _VISION:
            # open_clip writes 'ViT-B-16' for OpenAI's 'ViT-B/16': the last
            # dash is the patch separator
            head, _, tail = name.rpartition("-")
            canonical = f"{head}/{tail}"
        if canonical not in _VISION:
            raise KeyError(f"Unknown CLIP model {name}; have {list(_VISION)}")
        self.vcfg = clip_vision_config(canonical, dtype=dtype, quick=quick)
        ctx, vocab, twidth, theads, tlayers = _TEXT[canonical]
        self.tokenizer = SimpleTokenizer(bpe_path, vocab=vocab,
                                         allow_hash_fallback=allow_hash_tokenizer)
        vsd = tsd = None
        self.logit_scale = 100.0
        if checkpoint is not None:
            from anyloc_tpu_torch.models.convert import load_torch_checkpoint

            sd = load_torch_checkpoint(checkpoint)
            vsd = convert_clip_vision(sd, self.vcfg)
            tsd = convert_clip_text(sd, tlayers)
            self.logit_scale = float(np.exp(t2np(sd["logit_scale"])))
        self.vision = self._vision(vsd, seed)
        self.text = materialize(
            lambda: CLIPTextTower(vocab=vocab, width=twidth, heads=theads, layers=tlayers,
                                  context=ctx, embed_dim=self.vcfg.proj_dim, quick=quick),
            tsd, self.device, seed + 1, stds={"positional_embedding": 0.01,
                                              "text_projection": twidth ** -0.5})
        # the reference's per-item caches (_ensure_cache_dir, clip_wrapper.py:161-201)
        self.cache_dir = None
        if use_caching is not False and base_cache_dir is not None:
            sub = use_caching if isinstance(use_caching, str) else "global"
            safe = f"{impl}_{name}".replace("/", "_")
            self.cache_dir = os.path.join(base_cache_dir, "experiments", sub, safe)
            os.makedirs(os.path.join(self.cache_dir, "images"), exist_ok=True)
            os.makedirs(os.path.join(self.cache_dir, "text"), exist_ok=True)

    def _vision(self, state_dict, seed: int) -> ViT:
        from anyloc_tpu_torch.models.dinov2 import build_vit, init_params

        if state_dict is None:
            state_dict = init_params(self.vcfg, seed, device=self.device)
        return build_vit(self.vcfg, state_dict, None, device=self.device)

    # -- preprocessing ----------------------------------------------------
    def get_preprocessing(self, disable_prep: bool = True):
        if disable_prep:
            self.prep_apply = False
        size = self.vcfg.img_size
        mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
        std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

        def prep(pil_img):
            from PIL import Image

            w, h = pil_img.size
            scale = size / min(w, h)
            img = pil_img.resize((int(round(w * scale)), int(round(h * scale))), Image.BICUBIC)
            arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
            top = (arr.shape[0] - size) // 2
            left = (arr.shape[1] - size) // 2
            arr = arr[top:top + size, left:left + size]
            return (arr - mean) / std

        return prep

    def get_tokenizer(self, disable_prep: bool = True):
        if disable_prep:
            self.prep_apply = False
        return self.tokenizer.tokenize

    def _cache_path(self, kind: str, ci: Optional[str]) -> Optional[str]:
        if self.cache_dir is None or ci is None:
            return None
        return os.path.join(self.cache_dir, kind, f"{ci}.npz")

    def _cached(self, path: str, normalize: bool) -> torch.Tensor:
        out = torch.from_numpy(np.load(path)["desc"]).to(self.device)
        return l2_normalize(out) if normalize and not self.save_norm_descs else out

    def _store(self, out: torch.Tensor, path: Optional[str], normalize: bool) -> torch.Tensor:
        if normalize or (path and self.save_norm_descs):
            out = l2_normalize(out)
        if path:
            np.savez(path, desc=out.cpu().numpy())
        return out

    # -- encoding ----------------------------------------------------------
    @torch.inference_mode()
    def encode_image(self, image, normalize: bool = False, ci: Optional[str] = None
                     ) -> torch.Tensor:
        """Normalized channels-last image(s) [B, H, W, 3] (or [H, W, 3], or
        a PIL image with ``prep_apply``) -> [B, embed] float32 on the
        wrapper's device."""
        path = self._cache_path("images", ci)
        if path and os.path.exists(path):
            return self._cached(path, normalize)
        if self.prep_apply and not isinstance(image, (np.ndarray, torch.Tensor)):
            image = self.get_preprocessing(disable_prep=False)(image)
        arr = torch.as_tensor(np.asarray(image, np.float32) if not isinstance(image, torch.Tensor)
                              else image).to(self.device, torch.float32)
        if arr.dim() == 3:
            arr = arr[None]
        out = self.vision(arr)["cls"].float()
        return self._store(out, path, normalize)

    @torch.inference_mode()
    def encode_text(self, text, context_length: int = 77, normalize: bool = False,
                    ci: Optional[str] = None) -> torch.Tensor:
        path = self._cache_path("text", ci)
        if path and os.path.exists(path):
            return self._cached(path, normalize)
        toks = text
        if self.prep_apply or isinstance(text, (str, list)):
            toks = self.tokenizer.tokenize(text, context_length)
        toks = torch.as_tensor(np.asarray(toks, np.int64)).to(self.device)
        return self._store(self.text(toks).float(), path, normalize)

    def __call__(self, img, text, normalize: bool = False, context_length: int = 77,
                 ci_img=None, ci_text=None):
        """Zero-shot class probabilities (clip_wrapper.py:365-399):
        (probs [N_img, N_text], image features, text features)."""
        imf = self.encode_image(img, ci=ci_img)
        txf = self.encode_text(text, context_length, ci=ci_text)
        imn, txn = l2_normalize(imf), l2_normalize(txf)
        probs = torch.softmax(self.logit_scale * imn @ txn.T, dim=-1)
        if normalize:
            imf, txf = imn, txn
        return probs, imf, txf

    # -- statics -----------------------------------------------------------
    @staticmethod
    def load(impl, name, pretrained=None, **kwargs) -> "ClipWrapper":
        return ClipWrapper(impl, name, pretrained, **kwargs)

    @staticmethod
    def list_models(ret_vals: bool = False):
        models = {
            ClipWrapper.IMPL_OPENAI: sorted(_VISION),
            ClipWrapper.IMPL_OPEN_CLIP: sorted(n.replace("/", "-") for n in _VISION),
        }
        if ret_vals:
            return models
        for impl, names in models.items():
            print(f"{impl}: {names}")
