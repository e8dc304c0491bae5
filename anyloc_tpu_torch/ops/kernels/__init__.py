"""The port's hand-written Hopper kernels: Python wrappers, their plain
PyTorch versions (``<kernel>_ref``, used for CPU tensors and for checks),
and a launch count on each wrapper (``wrapper.launches``) that goes up by
one each time the wrapper launches its CUDA kernel."""

from anyloc_tpu_torch.ops.kernels.attn_proj import (
    MAX_FUSED_TOKENS,
    flash_attention_qkv_proj,
    flash_attention_qkv_proj_ref,
)
from anyloc_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
)
from anyloc_tpu_torch.ops.kernels.vlad_kernel import (
    vlad_aggregate_fused,
    vlad_aggregate_fused_ref,
)

# name -> wrapper, for code that resets or reads the launch counts
KERNELS = {
    "K1_vlad_aggregate_fused": vlad_aggregate_fused,
    "K2_flash_attention": flash_attention,
    "K5_flash_attention_qkv_proj": flash_attention_qkv_proj,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS", "MAX_FUSED_TOKENS", "flash_attention", "flash_attention_ref",
    "flash_attention_qkv_proj", "flash_attention_qkv_proj_ref",
    "launch_counts", "reset_launch_counts", "vlad_aggregate_fused",
    "vlad_aggregate_fused_ref",
]
