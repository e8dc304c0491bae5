"""ImageBind's multimodal surface against the JAX package's, in float32 on
the CPU: ``ImageBindModel`` with a tiny config of every tower (vision at
head dim 80, text, audio, depth, thermal, IMU), weights carried across by
``from_jax_params`` from the JAX towers' perturbed random trees;
``log_mel_spectrogram``; ``convert_imagebind_text`` / ``_patch`` on one
synthetic reference-layout state dict through both packages. Tolerance:
atol 1e-5 times the modality's logit scale (the outputs are unit vectors
times it) unless a test states another.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_families import _small_ib_config
from test_torch_models import _apply, _close, _init, _perturb

from anyloc_tpu.models import imagebind as jib
from anyloc_tpu.models.clip import SimpleTokenizer as JaxTokenizer

from anyloc_tpu_torch.models import imagebind as pib
from anyloc_tpu_torch.models.clip import SimpleTokenizer
from anyloc_tpu_torch.models.convert import from_jax_params, materialize

torch.set_num_threads(2)

SCALES = {"vision": 1.0, "text": 1 / 0.07, "audio": 20.0, "depth": 5.0, "thermal": 10.0,
          "imu": 5.0}
# (JAX tower, port tower, example input)
TOWERS = {
    "text": (lambda: jib.ImageBindText(vocab=500, context=16, embed_dim=32, depth=2, heads=4,
                                       out_dim=16),
             lambda: pib.ImageBindText(vocab=500, context=16, embed_dim=32, depth=2, heads=4,
                                       out_dim=16),
             (2, 16)),
    "audio": (lambda: jib._PatchTrunk(32, 2, 4, out_dim=16, kernel=16, stride=10),
              lambda: pib._PatchTrunk(32, 2, 4, out_dim=16, kernel=16, stride=10,
                                      in_hw=(128, 204)),
              (2, 128, 204)),
    "depth": (lambda: jib._PatchTrunk(32, 2, 4, out_dim=16, kernel=16),
              lambda: pib._PatchTrunk(32, 2, 4, out_dim=16, kernel=16, in_hw=(64, 64)),
              (2, 64, 64)),
    "thermal": (lambda: jib._PatchTrunk(32, 2, 4, out_dim=16, kernel=16),
                lambda: pib._PatchTrunk(32, 2, 4, out_dim=16, kernel=16, in_hw=(48, 64)),
                (2, 48, 64)),
    "imu": (lambda: jib._PatchTrunk(32, 2, 4, out_dim=16, kernel=8, mode="linear1d"),
            lambda: pib._PatchTrunk(32, 2, 4, out_dim=16, kernel=8, mode="linear1d",
                                    n_tokens=10),
            (2, 6, 83)),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, (2, 16)).astype(np.int32)
    ids[0, 5], ids[1, 11] = 499, 499          # the EOT (highest id) at two positions
    out = {"text": ids, "vision": rng.standard_normal((2, 28, 28, 3)).astype(np.float32)}
    for m in ("audio", "depth", "thermal", "imu"):
        out[m] = rng.standard_normal(TOWERS[m][2]).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    """The tiny multimodal model of both packages on one set of weights."""
    mp = pytest.MonkeyPatch()
    for mod in (jib, pib):
        mp.setattr(mod, "imagebind_vision_config", _small_ib_config(mod))
    x = _inputs()
    jm = jib.ImageBindModel.__new__(jib.ImageBindModel)
    jm.dtype, jm.seed = jnp.float32, 0
    jm.vision_cfg = jib.imagebind_vision_config(jnp.float32)
    from anyloc_tpu.models.vit import ViT

    jm.vision = ViT(jm.vision_cfg)
    jm.tokenizer = JaxTokenizer(vocab=500, allow_hash_fallback=True)
    jm._fns, jm.logit_scales = {}, dict(SCALES)
    jm._params = {"vision": _perturb(_init(jm.vision, jax.random.PRNGKey(0),
                                           jnp.asarray(x["vision"][:1])), 1)}
    rng = np.random.default_rng(2)
    jm._vision_head = ({"scale": 1 + 0.1 * rng.standard_normal(160).astype(np.float32),
                        "bias": 0.1 * rng.standard_normal(160).astype(np.float32)},
                       0.05 * rng.standard_normal((160, 1024)).astype(np.float32))
    pm = pib.ImageBindModel.__new__(pib.ImageBindModel)
    pm.dtype, pm.seed, pm.device = torch.float32, 0, torch.device("cpu")
    pm.vision = pib.ImageBindVision(dtype=torch.float32, device="cpu",
                                    params=from_jax_params(jm._params["vision"]),
                                    head=pib.from_jax_head(*jm._vision_head))
    pm.tokenizer = SimpleTokenizer(vocab=500, allow_hash_fallback=True)
    pm.logit_scales = dict(SCALES)
    for i, (m, (jmake, pmake, shape)) in enumerate(TOWERS.items()):
        tower = jmake()
        setattr(jm, m, tower)
        jm._params[m] = _perturb(_init(tower, jax.random.PRNGKey(i), jnp.asarray(x[m])), 3 + i)
        setattr(pm, m, materialize(pmake, from_jax_params(jm._params[m]), "cpu"))
    yield jm, pm, x
    mp.undo()


@pytest.mark.parametrize("modality", sorted(SCALES))
def test_imagebind_model_matches_jax(models, modality):
    """Each tower: the vision trunk (2 blocks, 2 heads of 80) and its head;
    text's causal trunk and EOT pooling; audio's 16 / 10 conv stem; depth
    and thermal's 16 / 16 stems at two sizes; IMU's linear patches (a
    ragged tail dropped); each times its logit scale."""
    jm, pm, x = models
    want = jm({modality: x[modality]})[modality]
    got = pm({modality: x[modality]})[modality]
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, atol=1e-5 * SCALES[modality])
    _close(got.norm(dim=-1), np.full(2, SCALES[modality]), atol=1e-5 * SCALES[modality])


def test_imagebind_text_takes_strings(models):
    """Strings go through CLIP's tokenizer to the text tower's context; the
    two tokenizers' hash fallbacks give the same ids."""
    jm, pm, _ = models
    prompts = ["a shopping mall", "an aerial view of a harbour"]
    np.testing.assert_array_equal(pm.tokenizer.tokenize(prompts, 16),
                                  jm.tokenizer.tokenize(prompts, 16))
    _close(pm({"text": prompts})["text"], jm({"text": prompts})["text"], atol=1e-5 * SCALES["text"])


@pytest.mark.parametrize("seconds", [1.0, 2.5, 0.3])
def test_log_mel_spectrogram_matches_jax(seconds):
    sr = 16000
    t = np.arange(int(sr * seconds), dtype=np.float32) / sr
    wave = np.sin(2 * np.pi * 440 * t) + 0.1 * np.random.default_rng(0).standard_normal(t.size)
    got = pib.log_mel_spectrogram(wave.astype(np.float32), sr)
    want = jib.log_mel_spectrogram(wave.astype(np.float32), sr)
    assert got.shape == (128, 204) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _trunk_sd(rng, prefix, depth, d, bias_kv):
    sd = {}

    def w(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"] = w(3 * d, d), w(3 * d)
        sd[f"{b}.attn.out_proj.weight"], sd[f"{b}.attn.out_proj.bias"] = w(d, d), w(d)
        if bias_kv:
            sd[f"{b}.attn.bias_k"], sd[f"{b}.attn.bias_v"] = w(1, 1, d), w(1, 1, d)
        for n in ("norm_1", "norm_2"):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = 1 + w(d), w(d)
        sd[f"{b}.mlp.fc1.weight"], sd[f"{b}.mlp.fc1.bias"] = w(4 * d, d), w(4 * d)
        sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"] = w(d, 4 * d), w(d)
    return sd


def _reference_sd(rng, d=32, depth=2):
    """ImageBind reference-layout tensors for the text, audio and IMU
    towers (shape-true at width ``d``)."""
    def w(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    sd = {"modality_preprocessors.text.token_embedding.weight": w(500, d, s=0.5),
          "modality_preprocessors.text.pos_embed": w(1, 16, d),
          "modality_heads.text.proj.0.weight": 1 + w(d), "modality_heads.text.proj.0.bias": w(d),
          "modality_heads.text.proj.1.weight": w(16, d, s=0.2)}
    sd.update(_trunk_sd(rng, "modality_trunks.text", depth, d, False))
    for m, stem, pos, head in (("audio", ("rgbt_stem", (d, 1, 16, 16)),
                                "pos_embedding_helper.pos_embed", 2),
                               ("imu", ("imu_stem", (d, 48)), "pos_embed", 3)):
        pre = f"modality_preprocessors.{m}."
        n = 228 if m == "audio" else 10
        sd.update({f"{pre}cls_token": w(1, 1, d), f"{pre}{stem[0]}.proj.weight": w(*stem[1]),
                   f"{pre}{pos}": w(1, n + 1, d), f"{pre}{stem[0]}.norm_layer.weight": 1 + w(d),
                   f"{pre}{stem[0]}.norm_layer.bias": w(d),
                   f"modality_heads.{m}.0.weight": 1 + w(d), f"modality_heads.{m}.0.bias": w(d),
                   f"modality_heads.{m}.{head}.weight": w(16, d, s=0.2)})
        sd.update(_trunk_sd(rng, f"modality_trunks.{m}", depth, d, True))
    return sd


@pytest.mark.parametrize("tower", ["text", "audio", "imu"])
def test_imagebind_converters_give_the_jax_model(tower):
    """One reference-layout state dict through both packages' converters:
    the port's is ``from_jax_params`` of the JAX tree, key for key, and
    the towers agree."""
    sd = _reference_sd(np.random.default_rng(9))
    if tower == "text":
        jparams, psd = jib.convert_imagebind_text(sd, depth=2), pib.convert_imagebind_text(sd, 2)
    else:
        jparams = jib.convert_imagebind_patch(sd, tower, depth=2)
        psd = pib.convert_imagebind_patch(sd, tower, depth=2)
    want_sd = from_jax_params(jparams)
    assert set(psd) == set(want_sd)
    for k in psd:
        _close(psd[k], want_sd[k], atol=0)
    jmake, pmake, shape = TOWERS[tower]
    x = _inputs(1)[tower]
    port = materialize(pmake, psd, "cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, _apply(jmake(), jparams, jnp.asarray(x)))


def test_imagebind_huge_full_builds_the_multimodal_model(monkeypatch):
    """``imagebind_huge(full=True)`` is ``ImageBindModel`` (tiny vision and
    towers patched in): every modality embeds, vision unit-norm."""
    monkeypatch.setattr(pib, "imagebind_vision_config", _small_ib_config(pib))
    real = pib._PatchTrunk

    def small_patch(embed_dim, depth, heads, **kw):
        return real(32, 1, 4, **{**kw, "out_dim": 16})

    monkeypatch.setattr(pib, "_PatchTrunk", small_patch)
    text = pib.ImageBindText
    monkeypatch.setattr(pib, "ImageBindText",
                        lambda dtype: text(embed_dim=32, depth=1, heads=4, out_dim=16))
    m = pib.imagebind_huge(full=True, device="cpu", allow_hash_tokenizer=True)
    assert isinstance(m, pib.ImageBindModel)
    rng = np.random.default_rng(0)
    out = m({"vision": rng.standard_normal((1, 28, 28, 3)).astype(np.float32),
             "text": ["a harbour"], "audio": rng.standard_normal((1, 128, 204)),
             "depth": rng.standard_normal((1, 224, 224)), "imu": rng.standard_normal((1, 6, 2000))})
    assert set(out) == {"vision", "text", "audio", "depth", "imu"}
    _close(out["vision"].norm(dim=-1), [1.0])
    _close(out["audio"].norm(dim=-1), [20.0], atol=2e-4)
