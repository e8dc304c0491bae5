"""Training on the card against the CPU, and K5's gradient against its
plain version's.

    python -m anyloc_tpu_torch.tools.train_checks [resnet18conv4 vit ...]

``compare_step``: one triplet step of GeoLocalizationNet + NetVLAD-64
(dvgl's resnet18conv4 at 480x640 or the vit backbone at 224 px) on a
reduced tuple (1 query, 1 positive, 2 negatives), one random state drawn
on the CPU (BatchNorm statistics calibrated on the tuple, so the
activations keep their scale), float32 with cuDNN's flags at PyTorch's
defaults. The vit's gradients: in every tensor all but ``SHARE`` of the
elements within ``BOUND`` of the CPU's largest |g| (the share allows rare
discrete flips of a decision on a value within float32 rounding of its
threshold). At a random init the CNN's gradients are ill-conditioned:
float32 runs differ from float64 by far more than ``BOUND`` on some
tensors, on the CPU as on the card, so they are held to a float64 run on the
CPU, each tensor's L2 distance from it at most ``CNN_RATIO`` times the
CPU float32 run's. That cannot see TF32 in a backward convolution (F17b)
under float32's own error there; ``compare_convs`` can: each
convolution of the CNN at the input shape the step gives it, its input
and weight gradients for a random output gradient on the card within
``BOUND`` of the CPU's largest |value|.
``k5_gradient`` / ``k2_gradient``: K5's and K2's gradients (the forward
kernel, then the backward kernels) against the plain version's autograd on
the same inputs, which shares nothing with the kernels. float32: each
gradient within ``BOUND`` of its largest |value|; reported beside it, not
part of ``ok``: ``float64``, each gradient's and the plain version's
largest difference from the float64 gradient (``float64_errors``).
``k2_float64_errors`` / ``k5_float64_errors`` hold the f32 attention
backward to float64 (F28), ``proj_bwd_float64_errors`` K5's f32
projection backward and ``k5_gradient_float64_errors`` K5's f32 gradient
end to end (F29): within twice the plain version's error in full
float32, plus ``F64_SLACK``. bfloat16
(``bf16_errors``): each gradient within ``BF16_BOUND`` of the plain
version's beyond one bf16 rounding step of it, and its L2 distance from the
float64 gradient of the same inputs at most ``BF16_RATIO`` times the plain
version's own; or within ``BOUND`` of the plain version's outright (an f32
gradient of the bf16 run, K5's bias, that sums the same f32 values in
another order: both then err at float32's level, where the ratio of two
distances is noise). K5's d_W and d LayerScale read the heads' outputs o
that the forward kernel keeps, which differ from the plain forward's
within the forward's bound, so their difference is taken from the plain
backward on that o (``flash_attention_qkv_proj_bwd_ref``), and what the
forward keeps is held to values from the inputs (``saved_errors``: o within
``BF16_BOUND`` of the plain forward's beyond one step, the log-sum-exp
within ``LSE_BOUND`` of float64's, the projection before LayerScale within
``BOUND`` of o·W + b); their distance from float64 is still over the plain
autograd's. The one-step allowance: the backward kernels mirror
the plain version's rounding points but sum in another order, and both
round each gradient to bfloat16 once at the end, so where the two f32 sums
straddle a rounding midpoint they land one step apart, 2^-8 to 2^-7 of the
value; ``bf16_readings`` records what a sound implementation in another
order (the plain autograd on the CPU) and a lower-precision one (the
library's bf16 attention backward) read on each measure.
``k5_step_times``: K5's forward launches and its backward, timed with CUDA
events inside whatever runs under it. Without a card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import sys

import numpy as np
import torch

from anyloc_tpu_torch.models.convert import materialize
from anyloc_tpu_torch.ops import kernels as K
from anyloc_tpu_torch.ops.kernels import attn_proj
from anyloc_tpu_torch.training.network import GeoLocalizationNet
from anyloc_tpu_torch.training.triplet import make_triplet_train_step

BOUND = 1e-4   # of the largest |g| of each tensor
BF16_BOUND = 2.5e-3   # bfloat16 gradients: of the largest |g|, beyond one rounding step
BF16_RATIO = 1.25     # bfloat16: L2 distance from float64 over the plain version's
LSE_BOUND = 1e-5      # K5's kept log-sum-exp: largest |difference| (natural log)
F64_SLACK = 1e-6      # float32 against float64: of max|g| beyond twice the plain version's
READ_O = ("w_proj", "layerscale")   # K5's gradients that read the forward's o
SHARE = 1e-3   # of a tensor's elements that may lie beyond BOUND
CNN_RATIO = 10.0   # card's distance from float64 / the CPU float32 run's
STEPS = {"resnet18conv4": (480, 640), "vit": (224, 224)}


def descriptor_fn(model):
    def fn(params, images):
        return torch.func.functional_call(model, params, (images,))

    return fn


def _grads(model, tuples: torch.Tensor) -> tuple:
    """(loss, {name: gradient on the CPU, float64}) of one step (SGD at lr
    0, so the weights stay) of ``model`` on its device."""
    params = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    step = make_triplet_train_step(descriptor_fn(model),
                                   functools.partial(torch.optim.SGD, lr=0.0), neg_num=2)
    state, loss = step(step.init_state(params), tuples)
    return loss.item(), {k: v.grad.detach().cpu().double() for k, v in state.params.items()
                         if v.requires_grad}


def _float64(model):
    """A float64 copy of a CNN GeoLocalizationNet on the CPU (its trunk
    casts its input to its config's dtype)."""
    out = copy.deepcopy(model).double()
    out.backbone.cfg = dataclasses.replace(out.backbone.cfg, dtype=torch.float64)
    return out


def compare_step(backbone: str, clusters: int = 64, seed: int = 3) -> dict:
    """One step's loss and gradients, card against CPU (module docstring)."""
    from anyloc_tpu_torch.tools._timing import require_card
    from anyloc_tpu_torch.tools.family_checks import calibrate_bn_

    require_card("train_checks")
    h, w = STEPS[backbone]

    def make():
        return GeoLocalizationNet(backbone, "netvlad", clusters, img_size=h)

    rng = np.random.default_rng(seed)
    tuples = torch.from_numpy(rng.standard_normal((1, 4, h, w, 3)).astype(np.float32))
    cpu = materialize(make, None, "cpu", seed=seed)
    with torch.inference_mode():
        calibrate_bn_(cpu, tuples[0])
    loss_cpu, want = _grads(cpu, tuples)
    K.reset_launch_counts()
    loss_card, got = _grads(materialize(make, cpu.state_dict(), "cuda"), tuples.cuda())
    torch.cuda.synchronize()
    counts = K.launch_counts()
    r = dict(backbone=backbone, hw=(h, w), tensors=len(want), loss_cpu=loss_cpu,
             loss_card=loss_card, counts=counts, names=set(got) == set(want))
    worst, name, share, share_name = 0.0, None, 0.0, None
    for k, g in want.items():
        err = (got[k] - g).abs() / max(g.abs().max().item(), 1e-30)
        if err.max().item() > worst:
            worst, name = err.max().item(), k
        out = (err > BOUND).float().mean().item()
        if out >= share:
            share, share_name = out, k
    r.update(worst=worst, worst_name=name, share=share, share_name=share_name)
    if backbone == "vit":
        return dict(r, ok=r["names"] and share <= SHARE)
    _, exact = _grads(_float64(cpu), tuples.double())
    ratio, ratio_name = 0.0, None
    for k, g in exact.items():
        cpu_err = (want[k] - g).norm().item()
        card_err = (got[k] - g).norm().item()
        q = card_err / max(cpu_err, 1e-12 * g.norm().item(), 1e-300)
        if q >= ratio:
            ratio, ratio_name = q, k
    return dict(r, ratio=ratio, ratio_name=ratio_name,
                ok=r["names"] and ratio <= CNN_RATIO)
def compare_convs(backbone: str = "resnet18conv4", seed: int = 3) -> dict:
    """Each convolution of the CNN at the input shape the step's 4 images
    give it (shapes seen once), backward card against CPU (module
    docstring): the largest error over the largest |value| of the input
    and weight gradients."""
    from anyloc_tpu_torch.ops.common import Conv2d
    from anyloc_tpu_torch.tools._timing import require_card

    require_card("train_checks")
    h, w = STEPS[backbone]
    model = materialize(lambda: GeoLocalizationNet(backbone, "netvlad", 64, img_size=h), None,
                        "cpu", seed=seed)
    shapes = {}

    def hook(mod, args):
        key = (mod.in_channels, mod.out_channels, mod.kernel_size, mod.stride, mod.padding,
               tuple(args[0].shape))
        shapes.setdefault(key, mod)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(4, h, w, 3))
    for handle in handles:
        handle.remove()
    g = torch.Generator().manual_seed(seed)
    worst, name = 0.0, None
    for key, conv in shapes.items():
        x = torch.randn(key[-1], generator=g)
        out = []
        for dev in ("cpu", "cuda"):
            c = copy.deepcopy(conv).to(dev).requires_grad_(True)
            xd = x.to(dev).requires_grad_(True)
            y = c(xd)
            gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed + 1)).to(dev)
            out.append([t.cpu() for t in torch.autograd.grad(y, [xd, c.weight], gy)])
        for which, a, b in zip(("input", "weight"), out[1], out[0]):
            err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            if err >= worst:
                worst, name = err, f"{which} grad, conv {key[0]}->{key[1]} k{key[2][0]} at {list(key[-1])}"
    return dict(backbone=backbone, convs=len(shapes), worst=worst, worst_name=name,
                ok=worst <= BOUND)


@contextlib.contextmanager
def planted_tf32_backward():
    """F17b planted: float32 convolutions compute their gradients outside
    ``ieee_convolutions`` (cuDNN's default, TF32 on the card) while the
    block runs, so that a run shows ``compare_convs`` sees the fault."""
    from anyloc_tpu_torch.ops import common

    real = common._Fp32Conv.backward

    def backward(ctx, grad):
        input, weight = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_bias and ctx.needs_input_grad[2]]
        gi, gw, gb = torch.ops.aten.convolution_backward(
            grad, input, weight, [weight.shape[0]] if has_bias else None, list(stride),
            list(padding), list(dilation), False, [0, 0], groups, mask)
        return gi, gw, gb, None, None, None, None

    common._Fp32Conv.backward = staticmethod(backward)
    try:
        yield
    finally:
        common._Fp32Conv.backward = real


def convs_line(r: dict) -> str:
    return (f"conv backward card vs CPU: {r['backbone']}'s {r['convs']} convolution shapes of "
            f"the step, float32: largest max|err| / max|g| {r['worst']:.3e} ({r['worst_name']}; "
            f"bound {BOUND:.0e}): {'ok' if r['ok'] else 'FAILED'}")


def step_line(r: dict) -> str:
    held = (f"largest L2 distance from the CPU's float64 gradient over the CPU float32 run's "
            f"{r['ratio']:.3f} ({r['ratio_name']}; bound {CNN_RATIO:g}); "
            if "ratio" in r else "")
    return (f"train step card vs CPU: {r['backbone']} + NetVLAD-64 at {r['hw'][0]}x{r['hw'][1]}, "
            f"1 + 1 + 2 images, float32: loss {r['loss_card']:.7f} (CPU {r['loss_cpu']:.7f}), "
            f"{r['tensors']} gradients: {held}largest share of elements beyond {BOUND:.0e} of "
            f"the tensor's max|g| against the CPU float32 {r['share']:.3e} ({r['share_name']}"
            f"{'' if held else f'; bound {SHARE:.0e}'}), largest max|err| / max|g| "
            f"{r['worst']:.3e} ({r['worst_name']}), K5 launches "
            f"{r['counts']['K5_flash_attention_qkv_proj']}: {'ok' if r['ok'] else 'FAILED'}")


def k5_inputs(b: int, n: int, h: int, hd: int, dtype=torch.float32, seed: int = 0,
              layerscale: bool = False, device: str = "cuda") -> dict:
    """K5's inputs as the vit backbone gives them (qkv, the projection's
    ``.t()`` weight, its bias, the residual; LayerScale optional), each
    requiring a gradient."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = h * hd

    def r(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=g, device=device) * scale).to(dt)

    out = dict(qkv=r(b, n, 3 * d), w_proj=r(d, d, scale=d ** -0.5).t(),
               b_proj=r(d, scale=0.1, dt=torch.float32),
               layerscale=r(d, scale=0.5, dt=torch.float32) if layerscale else None,
               residual=r(b, n, d))
    return {k: None if v is None else v.detach().requires_grad_(True) for k, v in out.items()}


def rel_err(a: torch.Tensor, w: torch.Tensor, scale: float = None) -> float:
    """max|a - w| over ``scale`` (default max|w|)."""
    scale = w.double().abs().max().item() if scale is None else scale
    return (a.double() - w.double()).abs().max().item() / max(scale, 1e-30)


def bf16_step(w: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of each bfloat16 value of ``w`` (0 at 0)."""
    w = w.double()
    _, e = torch.frexp(w)   # |w| = m · 2^e, m in [0.5, 1): 8 significant bits step 2^(e - 8)
    return torch.where(w == 0, torch.zeros_like(w), torch.ldexp(torch.ones_like(w), e - 8))


def bf16_errors(got: torch.Tensor, want: torch.Tensor, exact: torch.Tensor,
                top: float = None, near: torch.Tensor = None) -> dict:
    """A gradient ``got`` of a bfloat16 run against the plain version's
    autograd ``want`` and the float64 gradient ``exact`` of the same inputs
    (module docstring), each difference over max|want| (or ``top`` where
    given: a vanishing gradient's scale): ``raw``, the largest difference
    from ``want`` (or from ``near``, K5's plain backward on the forward
    kernel's o for the gradients that read it); ``err``, the same beyond
    one bf16 rounding step (a bf16 gradient; an f32 one has no step);
    ``ratio``, got's L2 distance from ``exact`` over want's, and
    ``ratio_max`` the same of the largest differences."""
    a, w, x = got.double(), want.double(), exact.double()
    if near is not None:
        w = near.double()
    step = bf16_step(w) if got.dtype == torch.bfloat16 else torch.zeros_like(w)
    top = max(w.abs().max().item() if top is None else top, 1e-30)
    diff = (a - w).abs()
    raw = diff.max().item() / top
    err = (diff - step).clamp_min(0).max().item() / top

    def over(num, den):
        return num / den if den > 0 else (0.0 if num == 0 else float("inf"))

    w = want.double()
    ratio = over((a - x).norm().item(), (w - x).norm().item())
    ratio_max = over((a - x).abs().max().item(), (w - x).abs().max().item())
    return dict(raw=raw, err=err, ratio=ratio, ratio_max=ratio_max,
                ok=raw <= BOUND or (err <= BF16_BOUND and ratio <= BF16_RATIO))


def _scales(wants) -> list:
    """Each gradient's largest |value|, or, for one that vanishes in exact
    arithmetic (below 1e-3 of the largest of the others: q's and k's at one
    key), the largest of the others."""
    tops = [w.double().abs().max().item() for w in wants]
    return [t if t >= 1e-3 * max(tops) else max(tops) for t in tops]


def _grad_report(names, got, want, exact=None, near=None) -> dict:
    """Per gradient against the plain version's autograd ``want``, over
    its ``_scales``: float32 (exact None) the largest error; bfloat16
    ``bf16_errors`` with the float64 gradient ``exact`` (and ``near``, a
    dict of the gradients held to another plain value)."""
    if exact is None:
        errs = {k: rel_err(a, w, top)
                for k, a, w, top in zip(names, got, want, _scales(want))}
        return dict(grad_errs=errs, worst=max(errs.values()),
                    grads_ok=max(errs.values()) <= BOUND)
    near = near or {}
    r = {k: bf16_errors(a, w, x, top, near.get(k)) for k, a, w, x, top in
         zip(names, got, want, exact, _scales(want))}
    return dict(grad_errs={k: v["err"] for k, v in r.items()},
                raws={k: v["raw"] for k, v in r.items()},
                ratios={k: v["ratio"] for k, v in r.items()},
                worst=max(v["err"] for v in r.values()),
                grads_ok=all(v["ok"] for v in r.values()))


def attention64(q, k, v, *, scale=None):
    """softmax(q kᵀ · scale) v without a rounding (float64 inputs)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1) @ v


@contextlib.contextmanager
def full_float32():
    """float32 matrix products in full float32 (no TF32) while the block
    runs: the plain versions' setting when they stand for float32's own
    error."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def float64_errors(names, got, plain, exact) -> dict:
    """Float32 results ``got`` (the kernels') and ``plain`` (the plain
    version's in full float32) against the float64 results ``exact`` of the
    same inputs, per name: each largest |difference| over the float64
    result's ``_scales``, and ``ok`` where the kernels' lies within twice the
    plain version's plus ``F64_SLACK`` (F27, F28)."""
    out = {}
    for name, a, p, x, top in zip(names, got, plain, exact, _scales(exact)):
        kernel, ref = rel_err(a, x, top), rel_err(p, x, top)
        out[name] = dict(kernel=kernel, plain=ref, ok=kernel <= 2 * ref + F64_SLACK)
    return out


def attention64_grads(q, k, v, grad, *, scale=None) -> list:
    """The float64 gradients of ``attention64`` for q, k, v [B, H, N, hd]
    (float64 copies of them and of ``grad``), a batch row at a time."""
    exact = [torch.empty(t.shape, dtype=torch.float64, device=t.device) for t in (q, k, v)]
    for i in range(q.shape[0]):
        wide = [t[i].detach().double().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            rows = torch.autograd.grad(attention64(*wide, scale=scale), wide, grad[i].double())
        for out, row in zip(exact, rows):
            out[i] = row
    return exact


def k2_float64_errors(b: int, h: int, n: int, hd: int, seed: int = 0,
                      device: str = "cuda") -> dict:
    """F28: K2's float32 gradient under autograd (``FlashAttentionGrad``:
    the forward kernel, then the attention backward's kernels) and its
    plain version's (``flash_attention_ref`` under autograd, full float32)
    against the float64 gradient of the same inputs, q, k, v and the output
    gradient [b, h, n, hd] drawn from ``seed``: ``float64_errors`` of dq,
    dk, dv. (``device`` another than cuda only to try the function: CPU
    tensors take the plain versions.)"""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, hd), generator=g, device=device).requires_grad_(True)
               for _ in range(3))
    grad = torch.randn((b, h, n, hd), generator=g, device=device)
    got = torch.autograd.grad(K.flash_attention(q, k, v), (q, k, v), grad)
    with full_float32():
        plain = torch.autograd.grad(K.flash_attention_ref(q, k, v), (q, k, v), grad)
    return float64_errors("qkv", got, plain, attention64_grads(q, k, v, grad))


def k5_float64_errors(b: int, n: int, h: int, hd: int, seed: int = 0,
                      device: str = "cuda") -> dict:
    """F28 on K5's layout: K5 under autograd (``QkvProjGrad``: the forward
    kernel, the projection backward, then the attention backward on strided
    columns of qkv and of its gradient) on float32 ``k5_inputs``, its qkv
    gradient (the attention backward's dq, dk, dv) against the float64
    attention backward given the same d_o, the one the projection backward
    hands it (``qkv_proj_bwd`` on the o the forward kernel keeps: the same
    bits), beside the plain version's (``attention_bwd_math`` in full
    float32 on the plain forward's o and log-sum-exp): ``float64_errors`` of
    "qkv". The projection backward's own error in d_o is
    ``bench_attention_bwd``'s ``f28`` reading, not this one's. (``device``
    another than cuda only to try the function, with a CPU stand-in for
    the forward kernel's launch.)"""
    from anyloc_tpu_torch.ops.kernels.flash_attention import attention_bwd_math

    inputs = k5_inputs(b, n, h, hd, torch.float32, seed, device=device)
    out = K.flash_attention_qkv_proj(num_heads=h, **inputs)
    grad = torch.randn(out.shape, generator=torch.Generator(device=device).manual_seed(seed + 1),
                       device=device)
    (got,) = torch.autograd.grad(out, [inputs["qkv"]], grad)
    scale = hd ** -0.5
    with torch.no_grad():
        x = {k: None if v is None else v.detach() for k, v in inputs.items()}
        keep = {}
        attn_proj._qkv_proj_launch(x["qkv"], x["w_proj"], x["b_proj"], num_heads=h,
                                   layerscale=None, residual=x["residual"], scale=scale,
                                   keep=keep)
        d_o = attn_proj.qkv_proj_bwd(grad, x["w_proj"], x["b_proj"], None, keep["o"], None,
                                     needs=(True, False, False, False))[0]
        views = attn_proj._split_heads(x["qkv"], h)

        def backward(q, k, v, d_o):
            s = (q * scale) @ k.transpose(-1, -2)
            o = torch.softmax(s, dim=-1) @ v
            grads = attention_bwd_math(q, k, v, o, torch.logsumexp(s, dim=-1), d_o,
                                       scale=scale, prescale_q=True)
            return torch.cat([t.transpose(1, 2).reshape(b, n, h * hd) for t in grads], dim=-1)

        with full_float32():
            plain = backward(*views, attn_proj._heads(d_o, h))
        exact = backward(*(t.double() for t in views), attn_proj._heads(d_o, h).double())
    return float64_errors(("qkv",), [got], [plain], [exact])


def proj_bwd_float64_errors(b: int, n: int, d: int, d_out: int = None, layerscale: bool = False,
                            seed: int = 0, device: str = "cuda") -> dict:
    """F29: K5's float32 projection backward alone (``qkv_proj_bwd``: d_o,
    d_w, d_b and, with LayerScale, d_ls) and its plain version's in full
    float32 against the float64 plain version on the same inputs: the
    output gradient [b, n, d_out], the weight W_O [d, d_out] (a ``.t()``
    view, as the trunk gives it), the bias, LayerScale, the heads' outputs o
    [b, n, d] and the projection before LayerScale pre = o·W + b (float32,
    as the forward keeps it), drawn from ``seed``; ``float64_errors`` of
    each. (CPU tensors take the plain version on both sides.)"""
    d_out = d if d_out is None else d_out
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    grad, w, bias, o = r(b, n, d_out), r(d_out, d, scale=d ** -0.5).t(), r(d_out, scale=0.1), \
        r(b, n, d)
    gamma = r(d_out, scale=0.5) if layerscale else None
    with torch.no_grad():
        with full_float32():
            pre = o @ w + bias if layerscale else None
            args = (grad, w, bias, gamma, o, pre)
            plain = attn_proj.qkv_proj_bwd_ref(*args)
        got = attn_proj.qkv_proj_bwd(*args)
        wide = [None if t is None else t.double() for t in args]
        if layerscale:
            wide[5] = wide[4] @ wide[1] + wide[2]
        exact = attn_proj.qkv_proj_bwd_ref(*wide)
    k = 4 if layerscale else 3
    return float64_errors(("d_o", "d_w", "d_b", "d_ls")[:k], got[:k], plain[:k], exact[:k])


def k5_gradient_float64_errors(b: int, n: int, h: int, hd: int, layerscale: bool = False,
                               seed: int = 0, device: str = "cuda") -> dict:
    """F29, end to end: K5's float32 gradient under autograd (``QkvProjGrad``:
    the forward kernel, the projection backward, the attention backward)
    for every input of ``k5_inputs`` (qkv, w_proj, b_proj, layerscale,
    residual) and the plain version's autograd in full float32, against
    the float64 autograd of the plain version on the same inputs:
    ``float64_errors`` of each gradient. (``device`` another than cuda only
    to try the function: CPU tensors take the plain versions.)"""
    inputs = k5_inputs(b, n, h, hd, torch.float32, seed, layerscale, device=device)
    names = [k for k, v in inputs.items() if v is not None]
    grad = torch.randn((b, n, h * hd),
                       generator=torch.Generator(device=device).manual_seed(seed + 1),
                       device=device)
    got = torch.autograd.grad(K.flash_attention_qkv_proj(num_heads=h, **inputs),
                              [inputs[k] for k in names], grad)
    with full_float32():
        plain = torch.autograd.grad(K.flash_attention_qkv_proj_ref(num_heads=h, **inputs),
                                    [inputs[k] for k in names], grad)
    wide = {k: None if v is None else v.detach().double().requires_grad_(True)
            for k, v in inputs.items()}
    exact = torch.autograd.grad(K.flash_attention_qkv_proj_ref(num_heads=h, **wide),
                                [wide[k] for k in names], grad.double())
    return float64_errors(names, got, plain, exact)


def saved_errors(inputs: dict, keep: dict, h: int) -> dict:
    """What K5's forward kernel keeps under autograd (``keep``: o, lse,
    pre) against values computed from the inputs alone (float64 where the
    plain version has no rounding): ``lse``, the largest |difference| from
    the log-sum-exp of the pre-scaled scores (natural log); ``o``, the
    heads' outputs against the plain forward's, beyond one bf16 step, over
    max|o|; ``pre``, against o·W + b from the kept o, over max|pre|."""
    qkv, w, bias = inputs["qkv"], inputs["w_proj"], inputs["b_proj"]
    b, n, three_d = qkv.shape
    d = three_d // 3
    scale = (d // h) ** -0.5
    q, k, v = attn_proj._split_heads(qkv, h)
    qs = (q.float() * scale).to(qkv.dtype)
    s = qs.double() @ k.double().transpose(-1, -2)
    plain = attn_proj._attention_ref(qs, k, v).transpose(1, 2).reshape(b, n, d)
    out = dict(lse=(keep["lse"].double() - torch.logsumexp(s, dim=-1)).abs().max().item(),
               o=bf16_errors(keep["o"], plain, plain)["err"])
    if keep["pre"] is not None:
        pre = keep["o"].double() @ w.double() + bias.double()
        out["pre"] = rel_err(keep["pre"], pre)
    return out


def saved_ok(errs: dict) -> bool:
    return (errs["lse"] <= LSE_BOUND and errs["o"] <= BF16_BOUND
            and errs.get("pre", 0.0) <= BOUND)


def k5_gradient(b: int, n: int, h: int, hd: int, dtype=torch.float32, seed: int = 0,
                layerscale: bool = False) -> dict:
    """K5's output and gradients for every input (the backward kernels)
    against the plain version's autograd on the same inputs (module
    docstring for the bounds; bfloat16's d_W and d LayerScale, which read
    the forward kernel's o, against the plain backward on that o once o,
    lse and pre pass ``saved_errors``), the forward's and the backward's
    launches, the grad_fn and whether the output is bit-equal to a launch
    without autograd."""
    inputs = k5_inputs(b, n, h, hd, dtype, seed, layerscale)
    names = [k for k, v in inputs.items() if v is not None]
    before = K.flash_attention_qkv_proj.launches
    out = K.flash_attention_qkv_proj(num_heads=h, **inputs)
    launched = K.flash_attention_qkv_proj.launches - before
    with torch.no_grad():
        bit_equal = torch.equal(out, K.flash_attention_qkv_proj(num_heads=h, **inputs))
    ref = K.flash_attention_qkv_proj_ref(num_heads=h, **inputs)
    grad = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                       device="cuda").to(dtype)
    before_bwd = K.flash_attention_qkv_proj_bwd.launches
    got = torch.autograd.grad(out, [inputs[k] for k in names], grad)
    bwd_launched = K.flash_attention_qkv_proj_bwd.launches - before_bwd
    with full_float32():
        want = torch.autograd.grad(ref, [inputs[k] for k in names], grad)
    wide = {k: None if v is None else v.detach().double().requires_grad_(True)
            for k, v in inputs.items()}
    exact = torch.autograd.grad(K.flash_attention_qkv_proj_ref(num_heads=h, **wide),
                                [wide[k] for k in names], grad.double())
    near, saved, f64 = None, {}, {}
    if dtype == torch.float32:
        f64 = float64_errors(names, got, want, exact)
        exact = None
    else:
        with torch.no_grad():
            x, keep = {k: None if v is None else v.detach() for k, v in inputs.items()}, {}
            attn_proj._qkv_proj_launch(x["qkv"], x["w_proj"], x["b_proj"], num_heads=h,
                                       layerscale=x["layerscale"], residual=x["residual"],
                                       scale=hd ** -0.5, keep=keep)
            saved = saved_errors(x, keep, h)
            on_o = dict(zip(["qkv", "w_proj", "b_proj", "layerscale", "residual"],
                            K.flash_attention_qkv_proj_bwd_ref(
                                grad, x["qkv"], x["w_proj"], x["b_proj"], x["layerscale"],
                                keep["o"], keep["lse"], keep["pre"], num_heads=h)))
            near = {k: on_o[k] for k in READ_O if on_o[k] is not None}
    torch.cuda.synchronize()
    r = _grad_report(names, got, want, exact, near)
    if saved:
        r.update(saved=saved, grads_ok=r["grads_ok"] and saved_ok(saved))
    if f64:
        r.update(float64=f64)
    return dict(shape=(b, n, 3 * h * hd), dtype=str(dtype).replace("torch.", ""),
                out_err=rel_err(out, ref), launched=launched, bwd_launched=bwd_launched,
                bit_equal=bit_equal, grad_fn=type(out.grad_fn).__name__, **r,
                ok=launched == 1 and bwd_launched == 1 and bit_equal and r["grads_ok"])


def k2_gradient(b: int, h: int, n: int, hd: int, dtype=torch.float32, seed: int = 0) -> dict:
    """K2 under autograd (``FlashAttentionGrad``) on q, k, v [b, h, n, hd]
    that require gradients: the output and the q, k, v gradients (the
    backward kernel) against the plain version's autograd on the same
    inputs (module docstring for the bounds), the forward's and the
    backward's launches, the grad_fn and whether the output is bit-equal to
    a launch without autograd."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, n, hd), generator=g, device="cuda").to(dtype)
               .requires_grad_(True) for _ in range(3))
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v)
    launched = K.flash_attention.launches - before
    with torch.no_grad():
        bit_equal = torch.equal(out, K.flash_attention(q, k, v))
    ref = K.flash_attention_ref(q, k, v)
    grad = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    before_bwd = K.flash_attention_bwd.launches
    got = torch.autograd.grad(out, (q, k, v), grad)
    bwd_launched = K.flash_attention_bwd.launches - before_bwd
    with full_float32():
        want = torch.autograd.grad(ref, (q, k, v), grad)
    exact = attention64_grads(q, k, v, grad)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        r = dict(_grad_report("qkv", got, want), float64=float64_errors("qkv", got, want, exact))
    else:
        r = _grad_report("qkv", got, want, exact)
    return dict(shape=(b, h, n, hd), dtype=str(dtype).replace("torch.", ""),
                out_err=rel_err(out, ref), launched=launched, bwd_launched=bwd_launched,
                bit_equal=bit_equal, grad_fn=type(out.grad_fn).__name__, **r,
                ok=launched == 1 and bwd_launched == 1 and bit_equal and r["grads_ok"])


# bfloat16 cases of the card tests (test_torch_gpu.py) and the smoke's step
READING_CASES = (
    ("K5", 48, 197, 12, 64, True), ("K5", 4, 257, 16, 80, False), ("K5", 2, 65, 4, 16, True),
    ("K5", 2, 65, 2, 32, True), ("K5", 2, 65, 2, 128, False), ("K5", 2, 1, 4, 64, True),
    ("K5", 2, 130, 2, 128, True), ("K2", 2, 8, 257, 64, None), ("K2", 2, 3, 65, 32, None),
    ("K2", 2, 2, 65, 128, None), ("K2", 2, 4, 1, 16, None), ("K2", 48, 6, 197, 64, None))


def _k5_library(qkv, w_proj, b_proj, *, num_heads, layerscale, residual, scale=None):
    """K5's function from library calls in bfloat16: the attention by
    ``scaled_dot_product_attention`` (whose backward rounds P and dS to
    bf16 for its products) and the projection as a bf16 matmul, rounded
    before the bias; the lower-precision control of ``bf16_readings``."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    scale = (d // num_heads) ** -0.5 if scale is None else scale
    q, k, v = attn_proj._split_heads(qkv, num_heads)
    o = torch.nn.functional.scaled_dot_product_attention(
        (q.float() * scale).to(qkv.dtype), k, v, scale=1.0)
    out = (o.transpose(1, 2).reshape(b, n, d) @ w_proj).float() + b_proj
    if layerscale is not None:
        out = out * layerscale
    return (out + residual.float()).to(qkv.dtype)


def bf16_readings(cases=READING_CASES, seed: int = 0, device: str = "cuda") -> list:
    """What ``bf16_errors`` reads, per gradient of each bfloat16 case
    (kernel, sizes, LayerScale), for three implementations held against the
    plain version's autograd on the card: the kernels; the plain version's
    autograd on the CPU (the same rounding points, sums in another order:
    a sound implementation); and the library's bf16 calls (K2: the
    attention by ``scaled_dot_product_attention``, K5: ``_k5_library``: a
    lower-precision one). ``device`` is where the kernels run (another
    than cuda only to try the function: CPU tensors take the plain
    versions)."""
    rows = []
    for kernel, *dims, ls in cases:
        g = torch.Generator(device=device).manual_seed(seed)
        if kernel == "K5":
            b, n, h, hd = dims
            inputs = k5_inputs(b, n, h, hd, torch.bfloat16, seed, ls, device)
            names = [k for k, v in inputs.items() if v is not None]

            def run(fn, device, inputs=inputs, names=names, h=h):
                x = {k: None if v is None else v.detach().to(device).requires_grad_(True)
                     for k, v in inputs.items()}
                return [t.to(grad.device) for t in torch.autograd.grad(
                    fn(num_heads=h, **x), [x[k] for k in names], grad.to(device))]

            grad = torch.randn((b, n, h * hd), generator=g, device=device).to(torch.bfloat16)
            impls = dict(kernel=(K.flash_attention_qkv_proj, device),
                         cpu_plain=(K.flash_attention_qkv_proj_ref, "cpu"),
                         library=(_k5_library, device))
            want = run(K.flash_attention_qkv_proj_ref, device)
            wide = {k: None if v is None else v.detach().double().requires_grad_(True)
                    for k, v in inputs.items()}
            exact = torch.autograd.grad(K.flash_attention_qkv_proj_ref(num_heads=h, **wide),
                                        [wide[k] for k in names], grad.double())
            shape = [b, n, 3 * h * hd]
        else:
            b, h, n, hd = dims
            qkv = [torch.randn((b, h, n, hd), generator=g, device=device).to(torch.bfloat16)
                   for _ in range(3)]
            grad = torch.randn((b, h, n, hd), generator=g, device=device).to(torch.bfloat16)
            names = list("qkv")

            def run(fn, device, qkv=qkv):
                x = [t.detach().to(device).requires_grad_(True) for t in qkv]
                return [t.to(grad.device) for t in torch.autograd.grad(fn(*x), x, grad.to(device))]

            impls = dict(kernel=(K.flash_attention, device),
                         cpu_plain=(K.flash_attention_ref, "cpu"),
                         library=(torch.nn.functional.scaled_dot_product_attention, device))
            want = run(K.flash_attention_ref, device)
            wide = [t.detach().double().requires_grad_(True) for t in qkv]
            exact = torch.autograd.grad(attention64(*wide), wide, grad.double())
            shape = [b, h, n, hd]
        for impl, (fn, device) in impls.items():
            got = run(fn, device)
            for name, a, w, x, top in zip(names, got, want, exact, _scales(want)):
                rows.append(dict(kernel=kernel, shape=shape, layerscale=bool(ls), impl=impl,
                                 grad=name, **bf16_errors(a, w, x, top)))
    return rows


def readings_line(r: dict) -> str:
    return (f"{r['kernel']} {r['shape']}{' LayerScale' if r['layerscale'] else ''} "
            f"{r['impl']:9s} d{r['grad']:10s}: max|diff| / max|g| {r['raw']:.3e}, beyond one "
            f"bf16 step {r['err']:.3e}; distance from float64 over the plain autograd's: L2 "
            f"{r['ratio']:.4f}, max {r['ratio_max']:.4f}; {'ok' if r['ok'] else 'refused'}")


@contextlib.contextmanager
def k5_step_times():
    """K5's forward launches and its backward, each between two CUDA
    events, while the block runs: yields a dict whose ``fwd_ms`` /
    ``bwd_ms`` (device time summed over the calls) and ``fwd`` / ``bwd``
    (call counts) are filled in on exit."""
    fwd, bwd = [], []
    launch, backward = attn_proj._qkv_proj_launch, attn_proj.QkvProjGrad.backward

    def timed(store, fn):
        def call(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            store.append((s, e))
            return out

        return call

    out = {}
    attn_proj._qkv_proj_launch = timed(fwd, launch)
    attn_proj.QkvProjGrad.backward = staticmethod(timed(bwd, backward))
    try:
        yield out
    finally:
        attn_proj._qkv_proj_launch = launch
        attn_proj.QkvProjGrad.backward = staticmethod(backward)
    torch.cuda.synchronize()
    out.update(fwd=len(fwd), bwd=len(bwd),
               fwd_ms=sum(s.elapsed_time(e) for s, e in fwd),
               bwd_ms=sum(s.elapsed_time(e) for s, e in bwd))


def main(argv=None) -> int:
    from anyloc_tpu_torch.tools._timing import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("backbones", nargs="*", choices=sorted(STEPS),
                    help=f"default: {' '.join(sorted(STEPS))}")
    ap.add_argument("--bf16-readings", metavar="JSON",
                    help="print bf16_readings (and write them to JSON), then stop")
    args = ap.parse_args(argv)
    print(f"card: {card_line()}", flush=True)
    if args.bf16_readings:
        import json
        import pathlib

        rows = bf16_readings()
        for r in rows:
            print(readings_line(r), flush=True)
        path = pathlib.Path(args.bf16_readings)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(card=card_line(), rows=rows), indent=1))
        return 0
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        r = k5_gradient(48, 197, 12, 64, dtype)
        bound = BOUND if dtype == torch.float32 else BF16_BOUND
        print(f"K5 gradient {r['dtype']} qkv {list(r['shape'])}: worst {r['worst']:.3e} "
              f"(bound {bound:.1e}), output {r['out_err']:.3e}", flush=True)
        ok &= r["ok"]
    for name in args.backbones or sorted(STEPS):
        r = compare_step(name)
        print(step_line(r), flush=True)
        ok &= r["ok"]
        if name != "vit":
            r = compare_convs(name)
            print(convs_line(r), flush=True)
            ok &= r["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
