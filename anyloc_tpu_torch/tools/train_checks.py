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
``k5_gradient``: K5's gradient (the kernel forward,
the plain version's backward, F18) against the plain version's autograd.
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
              layerscale: bool = False) -> dict:
    """K5's inputs as the vit backbone gives them (qkv, the projection's
    ``.t()`` weight, its bias, the residual; LayerScale optional), each
    requiring a gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    d = h * hd

    def r(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dt)

    out = dict(qkv=r(b, n, 3 * d), w_proj=r(d, d, scale=d ** -0.5).t(),
               b_proj=r(d, scale=0.1, dt=torch.float32),
               layerscale=r(d, scale=0.5, dt=torch.float32) if layerscale else None,
               residual=r(b, n, d))
    return {k: None if v is None else v.detach().requires_grad_(True) for k, v in out.items()}


def k5_gradient(b: int, n: int, h: int, hd: int, dtype=torch.float32, seed: int = 0) -> dict:
    """K5's output and gradients for every input against the plain
    version's autograd on the same inputs: the largest error over the
    largest |value| of each, and the kernel's launch."""
    inputs = k5_inputs(b, n, h, hd, dtype, seed)
    names = [k for k, v in inputs.items() if v is not None]
    before = K.flash_attention_qkv_proj.launches
    out = K.flash_attention_qkv_proj(num_heads=h, **inputs)
    launched = K.flash_attention_qkv_proj.launches - before
    ref = K.flash_attention_qkv_proj_ref(num_heads=h, **inputs)
    grad = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1),
                       device="cuda").to(dtype)
    got = torch.autograd.grad(out, [inputs[k] for k in names], grad)
    want = torch.autograd.grad(ref, [inputs[k] for k in names], grad)
    torch.cuda.synchronize()

    def rel(a, w):
        return (a.float() - w.float()).abs().max().item() / max(w.float().abs().max().item(),
                                                                1e-30)

    errs = {k: rel(a, w) for k, a, w in zip(names, got, want)}
    return dict(shape=(b, n, 3 * h * hd), dtype=str(dtype).replace("torch.", ""),
                out_err=rel(out, ref), grad_errs=errs, worst=max(errs.values()),
                launched=launched, grad_fn=type(out.grad_fn).__name__,
                ok=launched == 1 and max(errs.values()) <= BOUND)


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
    ap.add_argument("backbones", nargs="*", default=sorted(STEPS), choices=sorted(STEPS))
    args = ap.parse_args(argv)
    print(f"card: {card_line()}", flush=True)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        r = k5_gradient(48, 197, 12, 64, dtype)
        print(f"K5 gradient {r['dtype']} qkv {list(r['shape'])}: worst {r['worst']:.3e} "
              f"(bound {BOUND:.0e}), output {r['out_err']:.3e}", flush=True)
        ok &= r["ok"]
    for name in args.backbones:
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
