"""int8 W8A8 quantization for the frozen ViT trunk (counterpart of
``anyloc_tpu/ops/quant.py:35-175``).

* weights: static symmetric per-output-channel int8 (``quantize_weight_cols``),
  computed once at load time: int8 codes plus one f32 scale per output;
* activations: dynamic symmetric per-row int8 (``quantize_rows``);
* ``qdense``: per-row quantize, int8 x int8 -> int32 product, dequantize
  ``(acc * row_scale) * col_scale``, round to the output dtype, then add the
  bias in that dtype — the JAX package's order (``quant.py:100-104``).

Rounding is half to even (``torch.round``, like ``jnp.round``) and codes
are ``x / scale`` with a true division. The int8 product is
``torch._int_mm`` (exact int32 sums): the JAX package leaves this product
to XLA, and the port leaves it to PyTorch; it never runs as a float matmul.

Weights are in the port's ``nn.Linear`` layout [out, in] in the state dict
(``weight_q`` int8, ``weight_scale`` f32 [out]); the functions below take
the JAX layout [in, out], so a caller passes ``weight_q.t()`` (a view).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

CLIP = 127.0
MLP_MODULE_NAMES = ("fc1", "fc2", "w12", "w3")
QUANT_MODES = ("int8", "int8_mlp", "int8_fused", "int8_full")


def quantize_rows(x: torch.Tensor, clip: float = CLIP) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (int8 [..., K], f32 scale [..., 1]) with q * scale ~ x;
    the row max is taken in f32, scale = max(amax, 1e-6) / clip."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6) / clip
    q = torch.round(xf / scale).clamp_(-clip, clip)
    return q.to(torch.int8), scale


def quantize_weight_cols(w: torch.Tensor, clip: float = CLIP) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [K, N] -> (int8 [K, N], f32 scale [N]); scale = max(amax, 1e-9) / clip."""
    w32 = w.float()
    scale = torch.clamp_min(w32.abs().amax(dim=0), 1e-9) / clip
    q = torch.round(w32 / scale[None, :]).clamp_(-clip, clip)
    return q.to(torch.int8), scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact. PyTorch's CUDA
    int8 product (cuBLASLt) takes a row-major A with more than 16 rows and
    a column-major B — the ``weight_q.t()`` view of nn.Linear's storage, so
    the trunk's weights pass as they are; anything else is laid out so."""
    m = a.shape[0]
    if a.is_cuda:
        if m <= 16:
            a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
        a = a.contiguous()
        b = b.t().contiguous().t()
    return torch._int_mm(a, b)[:m]


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(xq @ wq) * x_scale * w_scale: xq [..., M, K] int8, wq [K, N] int8,
    x_scale [..., M, 1] f32, w_scale [N] f32 -> [..., M, N] ``out_dtype``."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    acc = _int_mm(xq.reshape(-1, k), wq).reshape(*lead, wq.shape[1])
    return (acc.float() * x_scale * w_scale).to(out_dtype)


def qdense(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, out_dtype=None) -> torch.Tensor:
    """Quantized dense layer: per-row activation quantize + int8 product;
    the result is rounded to ``out_dtype`` (default x's) before the bias is
    added in that dtype."""
    out_dtype = out_dtype or x.dtype
    xq, xs = quantize_rows(x)
    out = int8_matmul(xq, wq, xs, w_scale, out_dtype=out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def quantize_vit_params(state_dict: Mapping[str, torch.Tensor], mode: str = "int8",
                        *, min_size: int = 1 << 16) -> Dict[str, torch.Tensor]:
    """A port state dict -> the int8 layout ``ViTConfig(quant=mode)`` loads:
    every 2-D ``<module>.weight`` [out, in] with at least ``min_size``
    elements becomes ``<module>.weight_q`` (int8 [out, in]) and
    ``<module>.weight_scale`` (f32 [out]). "int8" and "int8_full" quantize
    all four block matmuls; "int8_fused" and "int8_mlp" only the MLP's
    (``MLP_MODULE_NAMES``), as ``quantize_tree``'s ``only_modules`` does in
    the JAX package. Everything else is returned as it is."""
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode must be one of {QUANT_MODES}, got {mode!r}")
    only_modules = MLP_MODULE_NAMES if mode in ("int8_fused", "int8_mlp") else None
    out: Dict[str, torch.Tensor] = {}
    for key, v in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        parent = prefix.rpartition(".")[2]
        if (leaf == "weight" and v.dim() == 2 and v.numel() >= min_size
                and (only_modules is None or parent in only_modules)):
            q, s = quantize_weight_cols(v.t())
            out[f"{prefix}.weight_q"] = q.t().contiguous()
            out[f"{prefix}.weight_scale"] = s
        else:
            out[key] = v
    return out
