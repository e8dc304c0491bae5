"""The attention backward (K2's and K5's gradients) at the training paths'
shapes, on one CUDA card, beside PyTorch's SDPA backward and the bounds.

Cases, random inputs from a torch seed on the card:
  * ``k2``: ``FlashAttentionGrad``'s backward under autograd at a
    tensor-parallel rank's q/k/v [48, 6, 197, 64] (dvgl ViT-B/16's 12 heads
    over model 2), float32 and bfloat16, beside
    ``scaled_dot_product_attention``'s backward on the same tensors, then
    the attention backward alone on them (``attention_bwd_launch``), whose
    time autograd's own work on the host does not cover;
  * ``k5``: ``QkvProjGrad``'s backward under autograd at the dvgl vit
    step's qkv [48, 197, 2304] (12 heads of 64), float32 and bfloat16, then
    its two halves alone on the same tensors: the attention backward on K5's
    strided views of qkv (``attention_bwd_launch``, pre-scaled q) and, where
    the tree has it, the projection backward (``qkv_proj_bwd``: d_o, d_W,
    d_b), beside its plain version (``qkv_proj_bwd_ref``, where the tree has
    it) and the library's route (two ``torch.mm`` in full float32 and a
    column sum: not one call), with the peak memory a call allocates beyond
    its outputs (its scratch) and, with ``--profile``, its launches split
    by kernel (``torch.profiler``, device time per call);
  * ``vith``: the same two at ViT-H's heads (MAE-H/14, ImageBind-H and
    SAM-H at 224 px: 16 heads of 80), K2 at q/k/v [8, 16, 257, 80] and K5
    at qkv [8, 257, 3840] with its attention half alone, float32 and
    bfloat16, beside SDPA's backward;
  * ``hds``: K2 at the other head dims the kernels take, q/k/v
    [8, 1280/hd, 257, hd] for hd 16, 32 and 128 (ViT-H's width cut into
    narrower or wider heads), float32 and bfloat16, as ``k2``;
  * ``k5fwd``: K5's bfloat16 forward alone (``flash_attention_qkv_proj``,
    with bias, LayerScale and residual, the weight a ``.t()`` view as the
    trunk gives it) at DINOv2-G's 308-px batch, qkv [32, 485, 4608] (24
    heads of 64), and at ViT-H's, qkv [32, 257, 3840] (16 heads of 80): a
    forward kernel timed on another tree (``--root``) against this one,
    with a digest of its output (the float64 sum and a hash of the bytes:
    two trees that agree in it computed the same bits) and its two
    launches' device time per call apart (``torch.profiler``: the attention
    kernel and the projection GEMM);
  * ``f27``: K2's float32 forward against float64 (``attention64``) beside
    its plain version's (``flash_attention_ref``) against the same, the
    largest |difference| over max|out|, at q/k/v [2, 16, N, hd] for N 257,
    685, 1370, 2740, 5330 and hd 64, 80, 128, two seeds each; then the f32
    forward's time at [8, 16, 1370, 80] and K5's at CLIP-L/14@336px's qkv
    [8, 577, 3072] (16 heads of 64);
  * ``f28``: K2's float32 gradient under autograd against float64
    (``train_checks.k2_float64_errors``: dq, dk, dv, each the largest
    |difference| over max|g| of the float64 gradient, beside the plain
    version's in full float32, the worst of two seeds) at q/k/v
    [2, 8, N, hd] for N 257, 685, 1370, 2740, 5330 and hd 64, 80, 128 (the
    split route), and N 1370, 5330 at hd 16, 32; K5 under autograd at
    ViT-H's qkv [2, 1370, 3840] (10 heads of 128, 16 of 80), each gradient
    end to end (``train_checks.k5_gradient``) and the qkv gradient given
    the d_o its projection backward hands the attention backward
    (``train_checks.k5_float64_errors``); then the port's other long
    float32 sums against float64 beside ``torch.mm`` / the plain version
    in full float32: K5's projection backward (``qkv_proj_bwd``: d_o, d_W,
    d_b) at the dvgl vit step's qkv [48, 197, 2304] and at DINOv2-G's width
    [32, 257, 4608], T1 in float32 (``OpTF32x3``) at
    [8704x1536]x[1536x8192], K5's float32 forward (attention and
    projection) at CLIP-L/14@336px's qkv [8, 577, 3072]; then the f32
    attention backward alone at [48, 6, 197, 64], [8, 16, 257, 80],
    [8, 10, 257, 128], [8, 16, 1370, 80] and [2, 8, 5330, 64], with two
    calls' largest difference;
  * ``f29``: K5's float32 projection backward against float64
    (``train_checks.proj_bwd_float64_errors``: d_o, d_W, d_b and, with
    LayerScale, d_ls, each beside the plain version's in full float32, the
    worst of two seeds) at the dvgl vit step's qkv [48, 197, 2304], ViT-H's
    [2, 1370, 3840] and DINOv2-G's [32, 257, 4608], the last also with
    LayerScale; K5's float32 gradient under autograd end to end
    (``train_checks.k5_gradient_float64_errors``: every input's) at
    [48, 197, 2304] (12 heads of 64), [2, 1370, 3840] (10 heads of 128 and
    16 of 80) and [32, 257, 4608] with LayerScale (24 heads of 64); the
    forward GEMM's ``OpTF32x3`` at the longest float32 K of the repo's
    models: K5's forward at ImageBind-H's qkv [8, 257, 3840] (K 1280) and
    CLIP-L/14@336px's [8, 577, 3072] (K 1024), T1 at
    [8704x1536]x[1536x8192] (K 1536); then ``f29time``'s times;
  * ``f29time``: the projection backward alone (``projection_half``) in
    float32 at [48, 197, 2304], [2, 1370, 3840] and [32, 257, 4608], and in
    bfloat16 at [48, 197, 2304]; K5's float32 forward at [48, 197, 2304],
    [8, 577, 3072] and [8, 257, 3840] and T1 in float32 at
    [8704x1536]x[1536x8192] (``f32_forward_times``); then one dvgl vit
    training step (GeoLocalizationNet vit + NetVLAD-64, 224 px, Adam, 4
    tuples of 12 images on the card), for timing two trees in turns.
Each time is the CUDA-event mean over ``iters`` calls, best of 3; the
bound is the larger of the operations (3xTF32 for float32: three tf32
products an f32 one, at 494.7 TFLOP/s; bfloat16 at 989 TFLOP/s) and the
bytes (each input read once, each output written once, at 3.35 TB/s), one
H100 SXM's dense peaks.

    python anyloc_tpu_torch/tools/bench_attention_bwd.py [--iters I] [--root DIR] [--profile]
        [--cases k2 k5 vith hds k5fwd f27 f28 f29 f29time]

``--root DIR`` imports ``anyloc_tpu_torch`` from another checkout (an
earlier commit unpacked with ``git archive``), so that two trees are timed
by the same script on the same card: run it once per tree, in turns (a
tree without the attention backward kernels takes ``--cases k5fwd`` only;
``f28`` and ``f29`` read ``train_checks``' float64 helpers: copy this
tree's ``tools/train_checks.py`` into a tree that lacks them).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

PEAK_TF32, PEAK_BF16, HBM = 494.7e12, 989e12, 3.35e12


def bound(ops: float, nbytes: float, dtype: str) -> dict:
    """The least time for ``ops`` operations (f32: as three tf32 products;
    bf16 at its own peak) and ``nbytes`` moved, and which of the two bounds
    it."""
    op_s = 3 * ops / PEAK_TF32 if dtype == "float32" else ops / PEAK_BF16
    by_bytes = nbytes / HBM
    return dict(bound_ms=1e3 * max(op_s, by_bytes),
                bound_by="operations" if op_s >= by_bytes else "bytes")


def projection_half(attn_proj, args, iters: int, profile: bool, **bounds) -> dict:
    """K5's projection backward alone (``qkv_proj_bwd``) on ``args``: its
    time, its plain version's (where the tree has ``qkv_proj_bwd_ref``),
    the library's route (d_o and d_W as two ``torch.mm`` in full float32,
    d_b a column sum), the memory a call allocates beyond its outputs, the
    launches a call makes (``qkv_proj_bwd.last_call``, where the tree has
    it) and, with ``profile``, the device time per call of each kernel it
    launches."""
    import torch

    from anyloc_tpu_torch.tools._timing import time_ms

    proj = attn_proj.qkv_proj_bwd
    grad, w, bias, _, o, _ = args
    r = dict(ms=time_ms(lambda: proj(*args), iters=iters), **bounds)
    plain = getattr(attn_proj, "qkv_proj_bwd_ref", None)
    if plain is not None:
        r["plain_ms"] = time_ms(lambda: plain(*args), iters=max(1, iters // 2))
    d = o.shape[-1]
    g2, o2, w2 = grad.reshape(-1, grad.shape[-1]).float(), o.reshape(-1, d).float(), w.float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # full float32, as the kernel's 3xTF32
    try:
        r["library_ms"] = time_ms(lambda: (torch.mm(g2, w2.t()), torch.mm(o2.t(), g2),
                                           g2.sum(0)), iters=iters)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    outs = proj(*args)
    torch.cuda.synchronize()
    r["scratch_mib"] = (torch.cuda.max_memory_allocated() - base
                        - sum(x.nbytes for x in outs if x is not None)) / 2 ** 20
    call = getattr(proj, "last_call", None)
    if call is not None:
        r["launches_per_call"] = dict(kernels=call["kernels"], memsets=call["memsets"])
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        calls = 5
        with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                proj(*args)
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0.0)
            if us > 0 and e.key not in ("cudaLaunchKernel", "cudaMemsetAsync"):
                split[e.key] = dict(ms_per_call=us / 1e3 / calls, count_per_call=e.count / calls)
        r["profile"] = split
    return r


CASES = ("k2", "k5", "vith", "hds", "k5fwd", "f27", "f28", "f29", "f29time")


def run(iters: int = 10, seed: int = 0, profile: bool = False, cases=CASES[:4]) -> dict:
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools._timing import card_line, require_card

    dev = require_card("bench_attention_bwd")
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {"card": card_line(), "package": K.__file__, "cases": {}}
    if "k2" in cases:
        out["cases"].update(k2_case(48, 6, 197, 64, g, iters, profile))
    if "k5" in cases:
        out["cases"].update(k5_case(48, 197, 12, 64, g, iters, profile))
    if "vith" in cases:
        out["cases"].update(k2_case(8, 16, 257, 80, g, iters, profile))
        out["cases"].update(k5_case(8, 257, 16, 80, g, iters, profile))
    if "hds" in cases:
        for hd in (16, 32, 128):
            out["cases"].update(k2_case(8, 1280 // hd, 257, hd, g, iters, profile))
    if "k5fwd" in cases:
        out["cases"].update(k5_forward_case(32, 485, 24, 64, g, iters))
        out["cases"].update(k5_forward_case(32, 257, 16, 80, g, iters))
    if "f27" in cases:
        out["cases"].update(f27_case(iters))
    if "f28" in cases:
        out["cases"].update(f28_case(iters))
    if "f29" in cases:
        out["cases"].update(f29_case())
    if "f29" in cases or "f29time" in cases:
        out["cases"].update(f29_times(iters))
    return out


# the attention backward's kernels, by a part of their names, for --profile
BWD_KERNELS = {"d": "attn_bwd_dot_kernel", "d_bf16": "attn_bwd_delta_kernel",
               "grads_wgmma": "attn_bwd_wgmma_kernel", "grads_mma_sync": "attn_bwd_kernel",
               "dq_sum": "attn_bwd_dq_kernel", "dq_wgmma": "attn_bwd_dq_wgmma_kernel"}


def k2_case(b: int, h: int, n: int, hd: int, g, iters: int, profile: bool = False) -> dict:
    """K2's backward under autograd at q/k/v [b, h, n, hd] beside SDPA's,
    then the attention backward alone on the same tensors, f32 and bf16
    (with ``profile``, each of its kernels' device time per call and the
    route it ran)."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_launch
    from anyloc_tpu_torch.tools._timing import time_ms

    dev, cases = g.device, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, h, n, hd), generator=g, device=dev).to(dtype)
                   .requires_grad_(True) for _ in range(3))
        o = K.flash_attention(q, k, v)
        go = torch.randn(o.shape, generator=g, device=dev).to(dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        name = str(dtype).replace("torch.", "")
        esz = 4 if dtype == torch.float32 else 2
        k2 = f"k2 [{b},{h},{n},{hd}] {name}"
        cases[k2] = dict(
            ms=time_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True),
                       iters=iters),
            library_ms=time_ms(lambda: torch.autograd.grad(sdpa, (q, k, v), go,
                                                           retain_graph=True), iters=iters),
            **bound(10 * b * h * n * n * hd, 8 * esz * b * h * n * hd, name))
        with torch.no_grad():   # the attention backward alone, no autograd around it
            lse = torch.logsumexp((q.float() @ k.float().transpose(-1, -2)) * hd ** -0.5, -1)
            grads = [torch.empty_like(q) for _ in range(3)]

            def alone():
                attention_bwd_launch(q, k, v, o, lse.contiguous(), go, *grads,
                                     scale=hd ** -0.5, prescale_q=False,
                                     name="bench_attention_bwd")

            cases[k2 + " kernel alone"] = dict(
                ms=time_ms(alone, iters=iters),
                **bound(10 * b * h * n * n * hd, 8 * esz * b * h * n * hd, name))
            if profile:
                from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_route

                split = kernel_split(alone, BWD_KERNELS)
                cases[k2 + " kernel alone"].update(
                    route=attention_bwd_route(hd, dtype),
                    **{k: v for k, v in split.items() if v > 0})
        del q, k, v, o, go, sdpa
    return cases


def k5_case(b: int, n: int, h: int, hd: int, g, iters: int, profile: bool) -> dict:
    """K5's backward under autograd at qkv [b, n, 3·h·hd], then its two
    halves alone on the same tensors, f32 and bf16."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kernels import attn_proj
    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_launch
    from anyloc_tpu_torch.tools import train_checks
    from anyloc_tpu_torch.tools._timing import time_ms

    dev, cases = g.device, {}
    d, m = h * hd, b * n
    scale = hd ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        esz = 4 if dtype == torch.float32 else 2
        inputs = train_checks.k5_inputs(b, n, h, hd, dtype)
        wanted = [t for t in inputs.values() if t is not None]
        o = K.flash_attention_qkv_proj(num_heads=h, **inputs)
        go = torch.randn(o.shape, generator=g, device=dev).to(dtype)
        k5 = f"k5 qkv [{b},{n},{3 * d}] {name}"
        cases[k5] = dict(
            ms=time_ms(lambda: torch.autograd.grad(o, wanted, go, retain_graph=True),
                       iters=iters),
            **bound(10 * b * h * n * n * hd + 4 * m * d * d,
                    esz * (2 * m * 3 * d + 2 * d * d + 2 * m * d) + 4 * d, name))
        with torch.no_grad():   # the attention half alone, on K5's views of qkv
            qkv = inputs["qkv"].detach()
            q, k, v = attn_proj._split_heads(qkv, h)
            s = (q.float() * scale) @ k.float().transpose(-1, -2)
            lse = torch.logsumexp(s, dim=-1).contiguous()
            att = (torch.softmax(s, dim=-1) @ v.float()).transpose(1, 2).reshape(b, n, d)
            att = att.to(dtype).contiguous()
            del s
            d_o = torch.randn((b, n, d), generator=g, device=dev).to(dtype)
            d_qkv = torch.empty_like(qkv)
            dq, dk, dv = attn_proj._split_heads(d_qkv, h)

            def attention():
                attention_bwd_launch(
                    q, k, v, attn_proj._heads(att, h), lse, attn_proj._heads(d_o, h), dq, dk,
                    dv, scale=scale, prescale_q=True, name="bench_attention_bwd")

            cases[k5 + " attention half"] = dict(
                ms=time_ms(attention, iters=iters),
                **bound(10 * b * h * n * n * hd, esz * 8 * m * d, name))
            proj = getattr(attn_proj, "qkv_proj_bwd", None)
            if proj is not None:
                args = (go, inputs["w_proj"].detach(), inputs["b_proj"].detach(), None, att,
                        None)
                cases[k5 + " projection half"] = projection_half(
                    attn_proj, args, iters, profile,
                    **bound(4 * m * d * d, esz * (3 * m * d + 2 * d * d) + 4 * d, name))
        del inputs, wanted, o, go
    return cases


def k5_forward_case(b: int, n: int, h: int, hd: int, g, iters: int) -> dict:
    """K5's bf16 forward alone at qkv [b, n, 3·h·hd] (bias, LayerScale,
    residual; the weight a ``.t()`` view), beside its bound: the attention's
    four products and the projection's, or the bytes."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools._timing import time_ms

    d, m, dev, bf = h * hd, b * n, g.device, torch.bfloat16

    def r(*shape, scale=1.0, dt=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    qkv, w = r(b, n, 3 * d), r(d, d, scale=d ** -0.5).t()
    kw = dict(b_proj=r(d, scale=0.1, dt=torch.float32),
              layerscale=r(d, scale=0.5, dt=torch.float32), residual=r(b, n, d), num_heads=h)
    with torch.no_grad():
        call = lambda: K.flash_attention_qkv_proj(qkv, w, **kw)  # noqa: E731
        ms = time_ms(call, iters=iters)
        out = call()
        split = kernel_split(call, {"attention": "flash_attn", "projection": "gemm_tma"})
    ops = 4 * b * h * n * n * hd + 2 * m * d * d
    nbytes = 2 * (m * 3 * d + d * d + 2 * m * d) + 2 * d * 4
    return {f"k5fwd qkv [{b},{n},{3 * d}] bfloat16": dict(
        ms=ms, digest=digest(out), **split, **bound(ops, nbytes, "bfloat16"))}


def digest(t) -> str:
    """A tensor's float64 sum and the first 16 hex digits of the SHA-256
    of its bytes: two outputs with the same digest hold the same bits."""
    import hashlib

    import torch

    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return f"{t.double().sum().item():.17g} {hashlib.sha256(raw).hexdigest()[:16]}"


def kernel_split(call, names: dict, calls: int = 5) -> dict:
    """The device time per call of each launch of ``call`` whose kernel
    name holds one of ``names``' values (``torch.profiler``), under the
    name's key with ``_ms``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    split = {f"{k}_ms": 0.0 for k in names}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        for k, part in names.items():
            if part in e.key and not e.key.startswith("cuda"):
                split[f"{k}_ms"] += us / 1e3 / calls
    return split


def f27_case(iters: int) -> dict:
    """K2's f32 forward and its plain version against float64 over N and
    the head dim (each the largest |difference| over max|out| of the
    float64 output, the worst of two seeds), then the f32 forward's time
    at [8, 16, 1370, 80] and K5's at CLIP-L/14@336px's qkv [8, 577, 3072]."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import train_checks

    cases = {}
    with torch.no_grad():
        for hd in (64, 80, 128):
            for n in (257, 685, 1370, 2740, 5330):
                kernel = plain = 0.0
                for seed in (0, 1):
                    g = torch.Generator(device="cuda").manual_seed(seed)
                    q, k, v = (torch.randn((2, 16, n, hd), generator=g, device="cuda")
                               for _ in range(3))
                    got, ref = K.flash_attention(q, k, v), K.flash_attention_ref(q, k, v)
                    for i in range(q.shape[0]):   # float64 scores [16, n, n] a batch row
                        exact = train_checks.attention64(q[i].double(), k[i].double(),
                                                         v[i].double())
                        top = exact.abs().max().item()
                        kernel = max(kernel, (got[i].double() - exact).abs().max().item() / top)
                        plain = max(plain, (ref[i].double() - exact).abs().max().item() / top)
                        del exact
                    del q, k, v, got, ref
                cases[f"f27 [2,16,{n},{hd}] float32"] = dict(kernel_err=kernel, plain_err=plain,
                                                             ratio=kernel / plain)
    cases.update(f32_forward_times(iters))
    return cases


def f32_forward_times(iters: int) -> dict:
    """The f32 forward's time at [8, 16, 1370, 80] (K2) and at
    CLIP-L/14@336px's qkv [8, 577, 3072] (K5, 16 heads of 64)."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools._timing import time_ms

    cases = {}
    with torch.no_grad():
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((8, 16, 1370, 80), generator=g, device="cuda") for _ in range(3))
        b, h, n, hd = q.shape
        cases["f27 time k2 [8,16,1370,80] float32"] = dict(
            ms=time_ms(lambda: K.flash_attention(q, k, v), iters=iters),
            **bound(4 * b * h * n * n * hd, 4 * 4 * b * h * n * hd, "float32"))
        qkv = torch.randn((8, 577, 3072), generator=g, device="cuda")
        w = (torch.randn((1024, 1024), generator=g, device="cuda") * 1024 ** -0.5).t()
        bias = torch.randn(1024, generator=g, device="cuda") * 0.1
        res = torch.randn((8, 577, 1024), generator=g, device="cuda")
        call = lambda: K.flash_attention_qkv_proj(qkv, w, bias, residual=res,  # noqa: E731
                                                  num_heads=16)
        b, n, d = 8, 577, 1024
        cases["f27 time k5 qkv [8,577,3072] float32"] = dict(
            ms=time_ms(call, iters=iters),
            **bound(4 * b * n * n * d + 2 * b * n * d * d, 4 * (b * n * 5 * d + d * d + d),
                    "float32"))
    return cases


def f28_case(iters: int) -> dict:
    """F28: K2's f32 gradient against float64 over N and the head dim
    (``train_checks.k2_float64_errors``, the worst of two seeds per
    gradient), the port's other long f32 sums against float64
    (``long_sums_float64``), then the f32 attention backward's time
    (``f32_backward_times``)."""
    import torch

    from anyloc_tpu_torch.tools import train_checks

    cases = {}
    sweep = [(hd, n) for hd in (64, 80, 128) for n in (257, 685, 1370, 2740, 5330)]
    sweep += [(hd, n) for hd in (16, 32) for n in (1370, 5330)]
    for hd, n in sweep:
        worst = {k: dict(kernel=0.0, plain=0.0) for k in "qkv"}
        for seed in (0, 1):
            for k, e in train_checks.k2_float64_errors(2, 8, n, hd, seed).items():
                for x in ("kernel", "plain"):
                    worst[k][x] = max(worst[k][x], e[x])
            torch.cuda.empty_cache()
        for e in worst.values():
            e["ok"] = e["kernel"] <= 2 * e["plain"] + train_checks.F64_SLACK
        cases[f"f28 k2 [2,8,{n},{hd}] float32 gradient"] = dict(float64=worst)
    for h, hd in ((10, 128), (16, 80)):   # K5 at ViT-H's width, under autograd
        name = f"f28 k5 qkv [2,1370,{3 * h * hd}] {h} heads float32 gradient"
        cases[name + ", end to end"] = dict(
            float64=train_checks.k5_gradient(2, 1370, h, hd, torch.float32)["float64"])
        cases[name + ", attention half given its d_o"] = dict(
            float64=train_checks.k5_float64_errors(2, 1370, h, hd))
    cases.update(long_sums_float64())
    cases.update(f32_backward_times(iters))
    return cases


def long_sums_float64() -> dict:
    """The port's other long f32 sums against float64, beside the plain
    version in full float32 (``train_checks.float64_errors``): K5's
    projection backward (``qkv_proj_bwd``: d_o a sum over D_out, d_W over
    row chunks) at qkv [48, 197, 2304] and [32, 257, 4608]; T1 f32
    (``OpTF32x3``: a sum over K) at [8704x1536]x[1536x8192] against
    ``torch.mm``; K5's f32 forward at
    qkv [8, 577, 3072] (no residual, so that the output is the attention's
    and the projection's)."""
    import torch

    from anyloc_tpu_torch.tools import train_checks

    cases = {}
    for b, n, d in ((48, 197, 768), (32, 257, 1536)):
        cases[f"f28 k5 projection backward qkv [{b},{n},{3 * d}] float32"] = dict(
            float64=train_checks.proj_bwd_float64_errors(b, n, d, seed=28))
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(28)
    cases["f28 t1 [8704x1536]x[1536x8192] float32"] = dict(float64=t1_float64(g))
    cases["f28 k5 forward qkv [8,577,3072] float32"] = dict(
        float64=k5_forward_float64(8, 577, 16, 64, g))
    torch.cuda.empty_cache()
    return cases


def t1_float64(g, m: int = 8704, k: int = 1536, n: int = 8192) -> dict:
    """T1 in float32 (``OpTF32x3``) at [m x k] x [k x n] against float64,
    beside ``torch.mm`` in full float32 (``train_checks.float64_errors``)."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import train_checks

    with torch.no_grad():
        a = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        with train_checks.full_float32():
            plain = torch.mm(a, w)
        r = train_checks.float64_errors(("out",), [K.matmul(a, w)], [plain],
                                        [a.double() @ w.double()])
    torch.cuda.empty_cache()
    return r


def k5_forward_float64(b: int, n: int, h: int, hd: int, g) -> dict:
    """K5's float32 forward (attention, then the projection GEMM on
    ``OpTF32x3``, K = h·hd) at qkv [b, n, 3·h·hd] against float64, beside
    its plain version in full float32; no residual, so that the output is
    the attention's and the projection's."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools import train_checks

    d = h * hd
    with torch.no_grad():
        qkv = torch.randn(b, n, 3 * d, generator=g, device="cuda")
        w = (torch.randn(d, d, generator=g, device="cuda") * d ** -0.5).t()
        bias = torch.randn(d, generator=g, device="cuda") * 0.1
        got = K.flash_attention_qkv_proj(qkv, w, bias, num_heads=h)
        with train_checks.full_float32():
            plain = K.flash_attention_qkv_proj_ref(qkv, w, bias, num_heads=h)
        exact = K.flash_attention_qkv_proj_ref(qkv.double(), w.double(), bias.double(),
                                               num_heads=h)
        r = train_checks.float64_errors(("out",), [got], [plain], [exact])
    torch.cuda.empty_cache()
    return r


# F29's shapes at the dvgl vit step's, ViT-H's and DINOv2-G's widths: the
# projection backward's (b, n, D, LayerScale) and K5's (b, n, heads, head
# dim, LayerScale), ViT-H's width in 10 heads of 128 and in 16 of 80
F29_PROJ = ((48, 197, 768, False), (2, 1370, 1280, False), (32, 257, 1536, False),
            (32, 257, 1536, True))
F29_K5 = ((48, 197, 12, 64, False), (2, 1370, 10, 128, False), (2, 1370, 16, 80, False),
          (32, 257, 24, 64, True))


def f29_case() -> dict:
    """F29: K5's float32 projection backward and its float32 gradient end
    to end against float64 (the worst of two seeds for the projection,
    one for the gradient), then ``OpTF32x3`` in the forward GEMM at the
    repo's longest float32 K."""
    import torch

    from anyloc_tpu_torch.tools import train_checks

    cases = {}
    for b, n, d, ls in F29_PROJ:
        worst = {}
        for seed in (0, 1):
            for k, e in train_checks.proj_bwd_float64_errors(b, n, d, layerscale=ls,
                                                             seed=seed).items():
                w = worst.setdefault(k, dict(kernel=0.0, plain=0.0))
                for x in ("kernel", "plain"):
                    w[x] = max(w[x], e[x])
            torch.cuda.empty_cache()
        for e in worst.values():
            e["ok"] = e["kernel"] <= 2 * e["plain"] + train_checks.F64_SLACK
        cases[f"f29 k5 projection backward qkv [{b},{n},{3 * d}]"
              f"{' layerscale' if ls else ''} float32"] = dict(float64=worst)
    for b, n, h, hd, ls in F29_K5:
        cases[f"f29 k5 gradient end to end qkv [{b},{n},{3 * h * hd}] {h} heads"
              f"{' layerscale' if ls else ''} float32"] = dict(
            float64=train_checks.k5_gradient_float64_errors(b, n, h, hd, layerscale=ls))
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(29)
    cases["f29 optf32x3 k5 forward qkv [8,257,3840] (K 1280) float32"] = dict(
        float64=k5_forward_float64(8, 257, 16, 80, g))
    cases["f29 optf32x3 k5 forward qkv [8,577,3072] (K 1024) float32"] = dict(
        float64=k5_forward_float64(8, 577, 16, 64, g))
    cases["f29 optf32x3 t1 [8704x1536]x[1536x8192] (K 1536) float32"] = dict(
        float64=t1_float64(g))
    return cases


def f29_times(iters: int) -> dict:
    """The projection backward alone (``projection_half``: its time, the
    plain version's, the library's route, its scratch) at F29's three
    widths in float32 and at the vit step's in bfloat16, then one dvgl vit
    training step's time."""
    import torch

    from anyloc_tpu_torch.ops.kernels import attn_proj

    cases = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, n, d, dtype in ((48, 197, 768, torch.float32), (2, 1370, 1280, torch.float32),
                           (32, 257, 1536, torch.float32), (48, 197, 768, torch.bfloat16)):
        with torch.no_grad():
            def r(*shape, scale=1.0, dt=dtype):
                return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dt)

            args = (r(b, n, d), r(d, d, scale=d ** -0.5).t(), r(d, scale=0.1, dt=torch.float32),
                    None, r(b, n, d), None)
            m = b * n
            name = str(dtype).replace("torch.", "")
            cases[f"f29 time projection backward qkv [{b},{n},{3 * d}] {name}"] = projection_half(
                attn_proj, args, iters, False,
                **bound(4 * m * d * d, (3 * m * d + 2 * d * d + d) * args[0].element_size(),
                        name))
            del args
        torch.cuda.empty_cache()
    cases.update(f32_forward_times(iters))
    cases["f29 time dvgl vit train step"] = vit_step_ms()
    return cases


def f32_forward_times(iters: int) -> dict:
    """The float32 GEMM of ``OpTF32x3`` where the repo's models run it: K5's
    float32 forward (attention, then the projection, bias and residual) at
    the dvgl vit step's qkv [48, 197, 2304], CLIP-L/14@336px's
    [8, 577, 3072] and ImageBind-H's [8, 257, 3840], and T1 in float32 at
    [8704x1536]x[1536x8192]: each time beside its bound (operations as three
    tf32 products; each input read once, the output written once)."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.tools._timing import time_ms

    cases = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for b, n, h, hd in ((48, 197, 12, 64), (8, 577, 16, 64), (8, 257, 16, 80)):
            d = h * hd
            qkv = torch.randn(b, n, 3 * d, generator=g, device="cuda")
            w = (torch.randn(d, d, generator=g, device="cuda") * d ** -0.5).t()
            bias = torch.randn(d, generator=g, device="cuda") * 0.1
            res = torch.randn(b, n, d, generator=g, device="cuda")
            ops = 4 * b * h * n * n * hd + 2 * b * n * d * d
            cases[f"f29 time k5 forward qkv [{b},{n},{3 * d}] float32"] = dict(
                ms=time_ms(lambda: K.flash_attention_qkv_proj(qkv, w, bias, num_heads=h,
                                                              residual=res), iters=iters),
                **bound(ops, 4 * (5 * b * n * d + d * d + d), "float32"))
            del qkv, w, bias, res
        m, k, n = 8704, 1536, 8192
        a = torch.randn(m, k, generator=g, device="cuda")
        wt = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        cases["f29 time t1 [8704x1536]x[1536x8192] float32"] = dict(
            ms=time_ms(lambda: K.matmul(a, wt), iters=iters),
            **bound(2 * m * k * n, 4 * (m * k + k * n + m * n), "float32"))
        del a, wt
    torch.cuda.empty_cache()
    return cases


def vit_step_ms() -> dict:
    """One dvgl vit training step (GeoLocalizationNet vit + NetVLAD-64 at
    224 px, float32, Adam, 4 tuples of 1 + 1 + 10 images already on the
    card), as ``chip_smoke.py``'s train phase times it: best of 2 means
    over 3 steps."""
    import functools

    import torch

    from anyloc_tpu_torch.models.convert import materialize
    from anyloc_tpu_torch.tools import train_checks
    from anyloc_tpu_torch.tools._timing import time_ms
    from anyloc_tpu_torch.training.network import GeoLocalizationNet
    from anyloc_tpu_torch.training.triplet import make_triplet_train_step

    model = materialize(lambda: GeoLocalizationNet("vit", "netvlad", 64, img_size=224), None,
                        "cuda", seed=0)
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    step = make_triplet_train_step(
        train_checks.descriptor_fn(model),
        functools.partial(torch.optim.Adam, lr=1e-5, betas=(0.9, 0.999), eps=1e-8))
    holder = [step.init_state(params)]
    tuples = torch.randn(4, 12, 224, 224, 3, device="cuda")

    def one():
        holder[0], loss = step(holder[0], tuples)
        return loss

    ms = time_ms(one, iters=3, reps=2, warmup=1)
    del model, params, step, holder, tuples
    torch.cuda.empty_cache()
    return dict(step_ms=ms)


def f32_backward_times(iters: int) -> dict:
    """The f32 attention backward alone (``attention_bwd_launch``) at the
    dvgl vit step's [48, 6, 197, 64], ViT-H's [8, 16, 257, 80], its width
    in 10 heads of 128 (the split route), and at N 1370 and 5330, where
    dK and dV take the most query steps; with two calls' largest
    difference."""
    import torch

    from anyloc_tpu_torch.ops import kernels as K
    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_launch
    from anyloc_tpu_torch.tools._timing import time_ms

    cases = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, h, n, hd in ((48, 6, 197, 64), (8, 16, 257, 80), (8, 10, 257, 128),
                        (8, 16, 1370, 80), (2, 8, 5330, 64)):
        with torch.no_grad():
            q, k, v, go = (torch.randn((b, h, n, hd), generator=g, device="cuda")
                           for _ in range(4))
            o = K.flash_attention(q, k, v)
            lse = torch.logsumexp((q @ k.transpose(-1, -2)) * hd ** -0.5, -1).contiguous()
            grads = [[torch.empty_like(q) for _ in range(3)] for _ in range(2)]

            def alone(out=grads[0]):
                attention_bwd_launch(q, k, v, o, lse, go, *out, scale=hd ** -0.5,
                                     prescale_q=False, name="bench_attention_bwd")

            ms = time_ms(alone, iters=iters)
            alone(grads[1])
            spread = max((a - c).abs().max().item() for a, c in zip(*grads))
            cases[f"f28 time k2 backward alone [{b},{h},{n},{hd}] float32"] = dict(
                ms=ms, spread=spread,
                **bound(10 * b * h * n * n * hd, 8 * 4 * b * h * n * hd, "float32"))
            del q, k, v, go, o, lse, grads
    return cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout to import anyloc_tpu_torch from (default: this one)")
    ap.add_argument("--profile", action="store_true",
                    help="split the projection half and the attention backward alone into "
                         "their kernels (torch.profiler)")
    ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES[:4]),
                    help="the cases to time (default: k2, k5, vith, hds)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    res = run(args.iters, profile=args.profile, cases=args.cases)
    for case, r in res["cases"].items():
        if "kernel_err" in r:
            print(f"[{res['card']}] {case}: kernel {r['kernel_err']:.3e}, plain "
                  f"{r['plain_err']:.3e} of max|out| from float64 ({r['ratio']:.2f}x)",
                  flush=True)
            continue
        if "float64" in r:
            errs = "; ".join(f"{k} kernel {e['kernel']:.3e}, plain {e['plain']:.3e} "
                             f"({e['kernel'] / max(e['plain'], 1e-30):.2f}x"
                             f"{'' if e['ok'] else ', PAST 2x + 1e-6'})"
                             for k, e in r["float64"].items())
            print(f"[{res['card']}] {case}: max|diff| / max|g| from float64: {errs}", flush=True)
            continue
        if "step_ms" in r:
            print(f"[{res['card']}] {case}: {r['step_ms']:.2f} ms", flush=True)
            continue
        lib = "".join(f", {k} {r[k]:.4f} ms" for k in ("plain_ms", "library_ms",
                                                        "attention_ms", "projection_ms",
                                                        *(f"{x}_ms" for x in BWD_KERNELS))
                      if k in r)
        if "route" in r:
            lib += f", route {r['route']}"
        if "scratch_mib" in r:
            lib += f", scratch {r['scratch_mib']:.1f} MiB"
        if "digest" in r:
            lib += f", digest {r['digest']}"
        if "spread" in r:
            lib += f", two calls {r['spread']:.1e} apart"
        print(f"[{res['card']}] {case}: {r['ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f} % of it", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
