"""What training needs of the port's models, against the JAX package's, in
float32 on the CPU:

  * ``train=True``: BatchNorm on batch statistics with Flax's semantics
    (biased batch variance, ``running = momentum * running + (1 -
    momentum) * batch``) for ResNet, EfficientNet (momentum 0.99),
    GeoLocalizationNet and VPRModel: outputs and the updated statistics
    against ``apply(..., train=True, mutable=["batch_stats"])``, within
    1e-5 of the largest value (the eval-path tests' bound); ResNet-50
    within 1e-3: 13 batch-normalized stages amplify float32 sums, and the
    JAX output lies farther from a float64 run of the port than the
    port's own float32 run does;
  * ``make_freeze_te_mask``: the same frozen set as the JAX regex through
    the converter's name map, and frozen parameters bit-equal after a step
    (JAX: ``multi_transform`` with ``set_to_zero``);
  * ``remat``: gradients bit-equal to those without it;
  * ``NetVLAD.init_from_descriptors`` from the JAX draw's start rows:
    centroids and assignment within 1e-5;
  * F17b: cuDNN's convolution precision reads "ieee" inside every float32
    convolution's backward (recorded by a dispatch mode at
    ``convolution_backward``, the op autograd runs), and is back afterwards;
  * F18: K5's ``autograd.Function`` (its kernel slot filled by the plain
    version here) gives the plain version's autograd gradients bit for bit,
    passes ``gradcheck`` in float64, and the other wrappers' guard raises
    under grad.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
import optax

from test_torch_backbones import _EN_STAGES, _conv_models
from test_torch_models import _init, _perturb

from anyloc_tpu.models import efficientnet as jeff
from anyloc_tpu.models import resnet as jres
from anyloc_tpu.training import aggregators as jagg
from anyloc_tpu.training import mixvpr as jmixvpr
from anyloc_tpu.training import network as jnetwork
from anyloc_tpu.training import triplet as jtriplet

from anyloc_tpu_torch.models import efficientnet as peff
from anyloc_tpu_torch.models import resnet as pres
from anyloc_tpu_torch.models.convert import from_jax_params, materialize
from anyloc_tpu_torch.ops.kernels import _launch
from anyloc_tpu_torch.ops.kernels import attn_proj
from anyloc_tpu_torch.training import aggregators as pagg
from anyloc_tpu_torch.training import mixvpr as pmixvpr
from anyloc_tpu_torch.training import network as pnetwork
from anyloc_tpu_torch.training import triplet as ptriplet

torch.set_num_threads(2)


def _rel_close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1e-30)
    assert err <= rel * scale, (err, scale)


# ------------------------------------------------------------------ train=True

TRAIN_MODELS = {
    "resnet18-conv4": (lambda: jres.ResNet(jres.resnet18_config(truncate="conv4")),
                       lambda: pres.ResNet(pres.resnet18_config(truncate="conv4")), 64),
    "resnet50-conv4": (lambda: jres.ResNet(jres.resnet50_config(truncate="conv4")),
                       lambda: pres.ResNet(pres.resnet50_config(truncate="conv4")), 96),
    "efficientnet": (lambda: jeff.EfficientNet(jeff.EfficientNetConfig(**_EN_STAGES)),
                     lambda: peff.EfficientNet(peff.EfficientNetConfig(**_EN_STAGES)), 48),
    "geo-resnet18conv4-netvlad": (
        lambda: jnetwork.GeoLocalizationNet("resnet18conv4", "netvlad", 4),
        lambda: pnetwork.GeoLocalizationNet("resnet18conv4", "netvlad", 4), 64),
    "vprmodel-resnet18-gem": (
        lambda: jmixvpr.VPRModel("resnet18", "gem", {"p": 3}, (4,)),
        lambda: pmixvpr.VPRModel("resnet18", "gem", {"p": 3}, (4,)), 64),
}


@pytest.mark.parametrize("name", sorted(TRAIN_MODELS))
def test_train_mode_matches_flax_batch_stats(name):
    """Two train=True forwards in a row (the second sees the statistics the
    first moved): outputs and statistics against Flax's."""
    jmake, pmake, px = TRAIN_MODELS[name]
    jmodel = jmake()
    x = np.random.default_rng(2).standard_normal((3, px, px, 3)).astype(np.float32)
    variables = jax.device_get(_perturb(
        _init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3))), 4))
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5 if a.ndim == 1 else a, variables["batch_stats"])}
    port = materialize(pmake, from_jax_params(variables), "cpu")
    apply = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))
    for _ in range(2):
        want, upd = apply(variables, jnp.asarray(x))
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        with torch.no_grad():
            got = port(torch.from_numpy(x), train=True)
        _rel_close(got, np.asarray(want), 1e-3 if name.startswith("resnet50") else 1e-5)
        stats = from_jax_params(jax.device_get(variables))
        buffers = dict(port.named_buffers())
        assert buffers and set(buffers) <= set(stats)
        for k, v in buffers.items():
            _rel_close(v, stats[k].numpy(), 1e-3 if name.startswith("resnet50") else 1e-5)


def test_batchnorm_train_is_not_torchs_convention():
    """Flax's update stores the biased batch variance with momentum 0.9 on
    the running value; nn.BatchNorm2d stores the unbiased one."""
    bn = pres.BatchNorm(3)
    x = torch.randn(2, 3, 4, 5)
    bn(x, train=True)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)), rtol=0, atol=1e-7)
    ref = torch.nn.BatchNorm2d(3, momentum=0.1)
    ref.train()(x)
    assert not torch.allclose(ref.running_var, bn.running_var, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ --freeze_te

def _jax_mask_as_port_names(jmodel, variables, freeze_te):
    """The JAX mask over the trainable tree, each leaf replaced by its
    boolean (as an array of the leaf's shape), through from_jax_params."""
    trainable, _ = jtriplet._split_trainable(variables)
    mask = jnetwork.make_freeze_te_mask(freeze_te)(trainable)
    tree = jax.tree_util.tree_map(lambda a, m: np.full(np.shape(a), float(m), np.float32),
                                  trainable, mask)
    return {k: bool(v.numel() and v.flatten()[0] == 1.0) for k, v in from_jax_params(tree).items()}


TOKEN_NETS = {"vit": (dict(backbone="vit", aggregation="netvlad", netvlad_clusters=4,
                           trunc_te=3), 32),
              "cct384": (dict(backbone="cct384", aggregation="netvlad", netvlad_clusters=4,
                              trunc_te=3), 384)}


@functools.lru_cache(maxsize=None)
def _token_net(which):
    kw, px = TOKEN_NETS[which]
    jmodel = jnetwork.GeoLocalizationNet(**kw)
    variables = jax.device_get(_perturb(
        _init(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3))), 6))
    pkw = dict(kw, img_size=px) if which == "vit" else kw
    port = materialize(lambda: pnetwork.GeoLocalizationNet(**pkw), from_jax_params(variables),
                       "cpu")
    return jmodel, variables, port, px


@pytest.mark.parametrize("freeze_te", [-1, 0, 1, 2])
@pytest.mark.parametrize("which", sorted(TOKEN_NETS))
def test_freeze_te_mask_freezes_the_jax_set(which, freeze_te):
    jmodel, variables, port, _ = _token_net(which)
    want = _jax_mask_as_port_names(jmodel, variables, freeze_te)
    names = [k for k, _ in port.named_parameters()]
    got = pnetwork.make_freeze_te_mask(freeze_te)(names)
    assert set(want) == set(names)
    assert got == want, {k for k in got if got[k] != want[k]}
    assert any(want.values()) and not all(want.values())


def _descriptor_fn(model):
    def fn(params, images):
        return torch.func.functional_call(model, params, (images,))

    return fn


def test_frozen_parameters_get_a_zero_update():
    """One SGD step on a 3-block ViT with --freeze-te 1, through JAX's
    multi_transform(set_to_zero) and the port's mask: frozen parameters
    bit-equal to their start in both, the others moved as JAX's within
    lr * 1e-4 of the largest |g| (test_torch_train.py's bounds)."""
    lr = 1e-2
    jmodel, variables, port, px = _token_net("vit")
    x = np.random.default_rng(7).standard_normal((1, 4, px, px, 3)).astype(np.float32)
    mask_fn = jnetwork.make_freeze_te_mask(1)

    def labels(params):
        return jax.tree_util.tree_map(lambda t: "train" if t else "freeze", mask_fn(params))

    opt = optax.multi_transform({"train": optax.sgd(lr), "freeze": optax.set_to_zero()}, labels)
    jstep = jtriplet.make_triplet_train_step(lambda v, im: jmodel.apply(v, im), opt, neg_num=2)
    jstate, _ = jstep(jstep.init_state(variables), jnp.asarray(x))
    jparams = from_jax_params(jax.device_get(jstate.params))

    params = {**dict(port.named_parameters()), **dict(port.named_buffers())}
    step = ptriplet.make_triplet_train_step(_descriptor_fn(port),
                                            lambda ps: torch.optim.SGD(ps, lr=lr), neg_num=2)
    mask = pnetwork.make_freeze_te_mask(1)(params)
    state = step.init_state(params, mask)
    start = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = step(state, torch.from_numpy(x))
    for k, t in state.params.items():
        if not mask[k]:
            assert not t.requires_grad and torch.equal(t, start[k]), k
            np.testing.assert_array_equal(jparams[k].numpy(), start[k].numpy())
        else:
            g = t.grad.numpy()
            bound = lr * 1e-4 * np.abs(g).max()
            np.testing.assert_allclose(t.detach().numpy(), jparams[k].numpy(), rtol=0,
                                       atol=bound + 1e-7)   # + one float32 ulp at |w| ~ 1
            assert not torch.equal(t.detach(), start[k]), k


# ------------------------------------------------------------------ remat

def test_remat_gradients_equal_the_plain_ones():
    """GeoLocalizationNet(vit, remat=True) recomputes each block in the
    backward: the same loss and bit-equal gradients; CCT refuses remat, as
    in the JAX package."""
    kw, px = TOKEN_NETS["vit"]
    _, variables, _, _ = _token_net("vit")
    sd = from_jax_params(variables)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, px, px, 3))
                         .astype(np.float32))
    grads = []
    for remat in (False, True):
        model = materialize(lambda: pnetwork.GeoLocalizationNet(**kw, remat=remat, img_size=px),
                            sd, "cpu").requires_grad_(True)
        assert model.backbone.cfg.remat is remat
        model(x).pow(2).sum().mul(0).add(model(x)[:, :7].sum()).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k
    with pytest.raises(ValueError, match="remat"):
        pnetwork.GeoLocalizationNet("cct384", "netvlad", remat=True)


def test_remat_only_checkpoints_when_a_gradient_is_built(monkeypatch):
    from anyloc_tpu_torch.models import vit as pvit

    calls = []
    monkeypatch.setattr(pvit, "checkpoint", lambda fn, x, **kw: calls.append(kw) or fn(x))
    kw, px = TOKEN_NETS["vit"]
    model = materialize(lambda: pnetwork.GeoLocalizationNet(**kw, remat=True, img_size=px),
                        None, "cpu")
    x = torch.zeros(1, px, px, 3)
    with torch.no_grad():
        model(x)
    assert calls == []
    model(x)
    assert calls == [{"use_reentrant": False}] * 3


# ------------------------------------------------------------------ NetVLAD k-means init

def test_netvlad_init_from_descriptors_matches_jax():
    rng = np.random.default_rng(9)
    descs = rng.standard_normal((300, 16)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    jvars = jax.device_get(_init(jagg.NetVLAD(6, 16), jax.random.PRNGKey(0),
                                 jnp.zeros((1, 5, 16))))
    want = jagg.NetVLAD.init_from_descriptors(jvars, descs, seed=3)["params"]
    rows = np.asarray(jax.random.choice(jax.random.PRNGKey(3), 300, shape=(6,), replace=False))
    start = from_jax_params(jvars)
    got = pagg.NetVLAD.init_from_descriptors(start, descs, seed=3, init_rows=rows)
    np.testing.assert_allclose(got["centroids"].numpy(), np.asarray(want["centroids"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["assign.weight"].numpy(),
                               np.asarray(want["assign"]["kernel"]).T, rtol=1e-5, atol=1e-5)
    # the module takes the result as its state dict
    net = materialize(lambda: pagg.NetVLAD(6, 16), got, "cpu")
    assert net(torch.from_numpy(descs[None, :10])).shape == (1, 96)
    # without rows: a torch.Generator draw from the seed, reproducible
    a = pagg.NetVLAD.init_from_descriptors(start, descs, seed=3)
    b = pagg.NetVLAD.init_from_descriptors(start, descs, seed=3)
    assert torch.equal(a["centroids"], b["centroids"])


# ------------------------------------------------------------------ F17b

class _RecordConvBackward(TorchDispatchMode):
    """Records cuDNN's convolution precision at each convolution_backward
    (the op that computes a convolution's input and weight gradients)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.seen.append((args[1].dtype, torch.backends.cudnn.conv.fp32_precision))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", sorted(_conv_models()))
def test_every_conv_backward_runs_in_full_float32(name):
    """F17b: each model's float32 convolutions compute their gradients with
    cuDNN's convolution precision "ieee", put back afterwards, while the
    process's flags stay at PyTorch's defaults; a bare F.conv2d's backward
    reads the default (so the recording sees the difference)."""
    make, px = _conv_models()[name]
    model = materialize(make, None, "cpu", seed=0).requires_grad_(True)
    x = torch.randn(1, px, px, 3) if name != "imagebind-depth" else torch.randn(1, px, px)
    out = model(x)
    out = out if isinstance(out, torch.Tensor) else next(
        v for v in out.values() if isinstance(v, torch.Tensor))
    before = torch.backends.cudnn.conv.fp32_precision
    with _RecordConvBackward() as rec:
        out.float().sum().backward()
    assert rec.seen and all(p == "ieee" for d, p in rec.seen if d == torch.float32), rec.seen
    assert torch.backends.cudnn.conv.fp32_precision == before
    assert torch.backends.cudnn.allow_tf32   # PyTorch's default, untouched
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    y = torch.nn.functional.conv2d(torch.randn(1, 3, 8, 8), w)
    with _RecordConvBackward() as rec:
        y.sum().backward()
    assert rec.seen == [(torch.float32, before)] and before != "ieee"


def test_conv_gradients_equal_autograds_own():
    """The backward of ops.common.Conv2d is autograd's convolution backward
    (bit-equal on the CPU), with and without a bias, strided, grouped."""
    from anyloc_tpu_torch.ops.common import Conv2d

    for kw in (dict(bias=True, stride=2, padding=1), dict(bias=False, groups=3, padding=2)):
        torch.manual_seed(0)
        conv = Conv2d(6, 9, 3, **kw)
        x = torch.randn(2, 6, 11, 10, requires_grad=True)
        g = torch.randn_like(conv(x))
        got = torch.autograd.grad(conv(x), [x, *conv.parameters()], g)
        ref = torch.nn.functional.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                                         conv.dilation, conv.groups)
        want = torch.autograd.grad(ref, [x, *conv.parameters()], g)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ------------------------------------------------------------------ F18

def _qkv_inputs(dtype=torch.float32, b=2, n=9, h=2, hd=8, d_out=16, ls=True, bias=True,
                seed=0):
    g = torch.Generator().manual_seed(seed)
    d = h * hd

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).requires_grad_(True)

    return dict(qkv=r(b, n, 3 * d), w_proj=r(d, d_out, scale=d ** -0.5),
                b_proj=r(d_out, scale=0.1) if bias else None,
                layerscale=r(d_out) if ls else None, residual=r(b, n, d_out)), h


def _ref_kernel(qkv, w_proj, b_proj, *, num_heads, layerscale, residual, scale):
    """The kernel slot filled by the plain version (what a launch computes)."""
    return attn_proj.flash_attention_qkv_proj_ref(qkv, w_proj, b_proj, num_heads=num_heads,
                                                  layerscale=layerscale, residual=residual,
                                                  scale=scale)


@pytest.mark.parametrize("ls,bias", [(True, True), (False, True), (False, False)])
def test_qkv_proj_function_gives_the_plain_gradient(ls, bias):
    inputs, h = _qkv_inputs(ls=ls, bias=bias)
    names = [k for k, v in inputs.items() if v is not None]
    out = attn_proj.QkvProjGrad.apply(_ref_kernel, h, 8 ** -0.5, inputs["qkv"],
                                      inputs["w_proj"], inputs["b_proj"],
                                      inputs["layerscale"], inputs["residual"])
    want = attn_proj.flash_attention_qkv_proj_ref(
        inputs["qkv"], inputs["w_proj"], inputs["b_proj"], num_heads=h,
        layerscale=inputs["layerscale"], residual=inputs["residual"])
    assert out.grad_fn is not None and torch.equal(out, want)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, [inputs[k] for k in names], g)
    ref = torch.autograd.grad(want, [inputs[k] for k in names], g)
    for k, a, b in zip(names, got, ref):
        assert torch.equal(a, b), k


def test_qkv_proj_function_passes_gradcheck_in_float64():
    inputs, h = _qkv_inputs(torch.float64, b=1, n=5, h=2, hd=4, d_out=8)
    args = (inputs["qkv"], inputs["w_proj"], inputs["b_proj"], inputs["layerscale"],
            inputs["residual"])
    assert torch.autograd.gradcheck(
        lambda *a: attn_proj.QkvProjGrad.apply(_ref_kernel, h, 0.5, *a), args)


def test_qkv_proj_function_skips_inputs_without_grad():
    """Only the inputs that require a gradient get one (a frozen weight)."""
    inputs, h = _qkv_inputs()
    w = inputs["w_proj"].detach()
    out = attn_proj.QkvProjGrad.apply(_ref_kernel, h, None or 8 ** -0.5, inputs["qkv"], w,
                                      inputs["b_proj"], inputs["layerscale"],
                                      inputs["residual"])
    out.sum().backward()
    assert w.grad is None and inputs["qkv"].grad is not None


def test_kernel_wrappers_refuse_a_gradient():
    """F18: with grad mode on and an input that requires a gradient, the
    guard every CUDA wrapper calls raises; under no_grad / inference_mode,
    or with no such input, it passes."""
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        _launch.refuse_grad("fused_mlp_int8", torch.zeros(2), t)
    with torch.no_grad():
        _launch.refuse_grad("fused_mlp_int8", t)
    with torch.inference_mode():
        _launch.refuse_grad("fused_mlp_int8", torch.zeros(2))
    _launch.refuse_grad("fused_mlp_int8", torch.zeros(2))
    # a CPU tensor never reaches the guard: the plain version keeps its graph
    x = torch.randn(1, 4, 24, requires_grad=True)
    w = torch.randn(8, 8)
    assert attn_proj.flash_attention_qkv_proj(x, w, num_heads=2).grad_fn is not None


def test_vit_trunk_gradient_reaches_the_patch_embedding():
    """Through the trunk's K5 route (its plain version on the CPU) the
    first block's qkv and the patch embedding get non-zero gradients."""
    kw, px = TOKEN_NETS["vit"]
    model = materialize(lambda: pnetwork.GeoLocalizationNet(**kw, img_size=px), None, "cpu",
                        seed=1).requires_grad_(True)
    model(torch.randn(2, px, px, 3)).sum().backward()
    for p in (model.backbone.patch_embed.proj.weight, model.backbone.blocks[0].attn.qkv.weight):
        assert p.grad is not None and p.grad.abs().max() > 0


def test_train_checks_need_a_card_and_put_the_backward_back():
    """The card-vs-CPU training checks raise without a card (no CPU
    fallback); the planted F17b fault they use to show their power is
    undone on exit."""
    from anyloc_tpu_torch.ops import common
    from anyloc_tpu_torch.tools import train_checks

    if not torch.cuda.is_available():
        for fn in (train_checks.compare_step, train_checks.compare_convs):
            with pytest.raises(RuntimeError, match="needs a CUDA card"):
                fn("resnet18conv4")
    real = common._Fp32Conv.backward
    with train_checks.planted_tf32_backward():
        assert common._Fp32Conv.backward is not real
        conv = common.Conv2d(2, 3, 3)
        x = torch.randn(1, 2, 5, 5, requires_grad=True)
        with _RecordConvBackward() as rec:
            conv(x).sum().backward()
        assert rec.seen and rec.seen[0][1] != "ieee"
    assert common._Fp32Conv.backward is real
