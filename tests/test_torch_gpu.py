"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; every test skips without a CUDA device. This file imports
no JAX, so on a machine with a card (and no JAX) run it without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: bfloat16 2e-2 absolute + 1e-2 relative (kernel and plain
version round to bf16 at the same points; the sums differ in order);
float32 2e-5 absolute (FMA order and the exp implementation).
"""

import numpy as np
import pytest
import torch

from anyloc_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_qkv_proj,
    flash_attention_qkv_proj_ref,
    flash_attention_ref,
    vlad_aggregate_fused,
    vlad_aggregate_fused_ref,
)

pytestmark = pytest.mark.gpu

BF16 = dict(atol=2e-2, rtol=1e-2)
F32 = dict(atol=2e-5, rtol=0)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _randn(*shape, dtype=torch.float32, seed=0, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(shape) * scale).astype(np.float32)).to("cuda", dtype)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [77, 130])
def test_flash_attention_kernel_matches_ref(hd, dtype, n):
    q, k, v = (_randn(2, 3, n, hd, dtype=dtype, seed=s) for s in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_single_token(dtype):
    q, k, v = (_randn(3, 2, 1, 64, dtype=dtype, seed=s) for s in range(3))
    torch.testing.assert_close(flash_attention(q, k, v).float(), v.float(), atol=0, rtol=0)


def test_flash_attention_kernel_takes_qkv_views():
    b, n, h, hd = 2, 300, 4, 64
    d = h * hd
    qkv = _randn(b, n, 3 * d, dtype=torch.bfloat16)
    views = [qkv[..., i * d:(i + 1) * d].view(b, n, h, hd).transpose(1, 2) for i in range(3)]
    got = flash_attention(*views)
    want = flash_attention_ref(*views)
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", [True, False])
def test_qkv_proj_kernel_matches_ref(dtype, epilogue):
    b, n, h, hd = 3, 97, 4, 64
    d = h * hd
    qkv = _randn(b, n, 3 * d, dtype=dtype, seed=1)
    w = _randn(d, d, dtype=dtype, seed=2, scale=d ** -0.5).t()   # Linear layout
    kw = {}
    if epilogue:
        kw = dict(b_proj=_randn(d, seed=3, scale=0.1), layerscale=_randn(d, seed=4, scale=0.5),
                  residual=_randn(b, n, d, dtype=dtype, seed=5, scale=0.5))
    before = flash_attention_qkv_proj.launches
    got = flash_attention_qkv_proj(qkv, w, num_heads=h, **kw)
    assert flash_attention_qkv_proj.launches == before + 1
    want = flash_attention_qkv_proj_ref(qkv, w, num_heads=h, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **(BF16 if dtype == torch.bfloat16 else F32))


@pytest.mark.parametrize("vlad_mode,dist_mode", [
    ("hard", "cosine"), ("hard", "euclidean"), ("soft", "cosine")])
@pytest.mark.parametrize("norm_descs", [True, False])
@pytest.mark.parametrize("intra_norm", [True, False])
def test_vlad_kernel_matches_ref(vlad_mode, dist_mode, norm_descs, intra_norm):
    descs = _randn(3, 333, 192, seed=6)
    centers = _randn(32, 192, seed=7)
    kw = dict(vlad_mode=vlad_mode, dist_mode=dist_mode, norm_descs=norm_descs,
              intra_norm=intra_norm, soft_temp=2.0)
    before = vlad_aggregate_fused.launches
    got = vlad_aggregate_fused(descs, centers, **kw)
    assert vlad_aggregate_fused.launches == before + 1
    want = vlad_aggregate_fused_ref(descs, centers, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("c", [1, 5, 64])
def test_vlad_kernel_cluster_counts(c):
    descs = _randn(2, 70, 96, seed=8)
    centers = _randn(c, 96, seed=9)
    for mode in ("hard", "soft"):
        got = vlad_aggregate_fused(descs, centers, vlad_mode=mode)
        want = vlad_aggregate_fused_ref(descs, centers, vlad_mode=mode)
        torch.testing.assert_close(got, want, **F32)


def test_kernels_refuse_what_they_do_not_take():
    q = _randn(1, 2, 10, 24)                     # head dim 24
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        vlad_aggregate_fused(_randn(2, 10, 16).transpose(0, 1), _randn(4, 16))
