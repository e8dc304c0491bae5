"""The port's hand-written Hopper kernels: Python wrappers, their plain
PyTorch versions (``<kernel>_ref``, used for CPU tensors and for checks),
and a launch count on each wrapper (``wrapper.launches``) that goes up by
one each time the wrapper launches its CUDA kernels."""

from anyloc_tpu_torch.ops.kernels.attn_proj import (
    MAX_FUSED_TOKENS,
    attention_proj,
    attention_proj_ref,
    attn_geometry_ok,
    attn_half_variant,
    attn_half_variant_proj_ref,
    attn_half_variant_ref,
    flash_attention_qkv_proj,
    flash_attention_qkv_proj_bwd,
    flash_attention_qkv_proj_bwd_ref,
    flash_attention_qkv_proj_ref,
    fused_attn_half_bf16,
    fused_attn_half_bf16_ref,
    fused_attn_half_int8,
    fused_attn_half_int8_ref,
)
from anyloc_tpu_torch.ops.kernels.fused_block import (
    fused_block_int8,
    fused_block_int8_ref,
)
from anyloc_tpu_torch.ops.kernels.flash_attention import (
    attention_bwd_split,
    attention_bwd_wgmma,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from anyloc_tpu_torch.ops.kernels.fused_mlp import (
    fused_mlp_bf16,
    fused_mlp_bf16_ref,
    fused_mlp_int8,
    fused_mlp_int8_ref,
    int8_mlp_geometry_ok,
)
from anyloc_tpu_torch.ops.kernels.matmul import (
    matmul,
    matmul_dequant,
    matmul_dequant_ref,
    matmul_ref,
)
from anyloc_tpu_torch.ops.kernels.vlad_kernel import (
    vlad_aggregate_fused,
    vlad_aggregate_fused_ref,
    vlad_plan,
)

# name -> wrapper, for code that resets or reads the launch counts
KERNELS = {
    "K1_vlad_aggregate_fused": vlad_aggregate_fused,
    "K2_flash_attention": flash_attention,
    "K3_fused_mlp_int8": fused_mlp_int8,
    "K4_fused_attn_half_int8": fused_attn_half_int8,
    "K5_flash_attention_qkv_proj": flash_attention_qkv_proj,
    "K6_attention_proj": attention_proj,
    "K7_fused_attn_half_bf16": fused_attn_half_bf16,
    "K8_fused_mlp_bf16": fused_mlp_bf16,
    "K9_fused_block_int8": fused_block_int8,
    "T1_matmul": matmul,
    "T2_matmul_dequant": matmul_dequant,
    "T3_attn_half_variant": attn_half_variant,
    # the backward kernels of K2 and K5 (their gradients under autograd)
    "K2b_flash_attention_bwd": flash_attention_bwd,
    "K5b_flash_attention_qkv_proj_bwd": flash_attention_qkv_proj_bwd,
    # the attention backward that both launch, by the route its head dim and
    # dtype take (attention_bwd_route): one of these counts each launch
    "Kab_attention_bwd_wgmma": attention_bwd_wgmma,
    "Kab_attention_bwd_split": attention_bwd_split,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS", "MAX_FUSED_TOKENS", "attention_bwd_split", "attention_bwd_wgmma",
    "attention_proj", "attention_proj_ref",
    "attn_geometry_ok", "attn_half_variant", "attn_half_variant_proj_ref", "attn_half_variant_ref",
    "flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
    "flash_attention_ref",
    "flash_attention_qkv_proj", "flash_attention_qkv_proj_bwd",
    "flash_attention_qkv_proj_bwd_ref", "flash_attention_qkv_proj_ref",
    "fused_attn_half_bf16", "fused_attn_half_bf16_ref", "fused_attn_half_int8",
    "fused_attn_half_int8_ref", "fused_block_int8", "fused_block_int8_ref",
    "fused_mlp_bf16", "fused_mlp_bf16_ref", "fused_mlp_int8",
    "fused_mlp_int8_ref", "int8_mlp_geometry_ok",
    "launch_counts", "matmul", "matmul_dequant", "matmul_dequant_ref", "matmul_ref",
    "reset_launch_counts", "vlad_aggregate_fused",
    "vlad_aggregate_fused_ref", "vlad_plan",
]
