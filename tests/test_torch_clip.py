"""The port's CLIP (tokenizer, towers, ``ClipWrapper``) and its pipelines
(``clip-top-k``, ``patch-clip``, ``trivial_clip_vpr``) against the JAX
package's, on the CPU.

The port's tokenizer splits words with ``unicodedata`` categories where
the JAX one uses the ``regex`` module: both run on the committed BPE
fixture and on hypothesis-generated strings of characters that Python's
Unicode tables assign (the two modules' tables are of different Unicode
versions: a character assigned only in the newer one is a letter for
``regex`` and unassigned here). The towers are a ViT-T/16 CLIP (width
128, 2 heads of 64; text width 32) registered in both packages for the
test, loaded from one OpenAI-layout checkpoint written from a numpy seed.
Float32; tolerance atol 1e-5 unless a test states another.
"""

import glob
import json
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from anyloc_tpu import cli as jax_cli
from anyloc_tpu.config import PipelineArgs as JaxArgs
from anyloc_tpu.config import parse_args as jax_parse_args
from anyloc_tpu.data import synthetic as jax_synthetic
from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.models import clip as jclip
from anyloc_tpu.pipelines import clip_pipelines as jpipes
from anyloc_tpu.pipelines import extras as jextras

import anyloc_tpu_torch as port
from anyloc_tpu_torch import cli
from anyloc_tpu_torch.config import PipelineArgs, parse_args
from anyloc_tpu_torch.models import clip as pclip
from anyloc_tpu_torch.models.convert import materialize
from anyloc_tpu_torch.pipelines import clip_pipelines as ppipes
from anyloc_tpu_torch.pipelines import extras

torch.set_num_threads(2)

FIXTURE = pathlib.Path(__file__).parent / "fixtures"
BPE = FIXTURE / "bpe"
E2E = FIXTURE / "e2e"
STRINGS = [
    "hello world", "a photo of the city", "building 123 street", "the cat's hat, and more.",
    "  Weird   WHITESPACE\tand CASE  ", "café naïve", "unmergeable zxqj tokens",
    "<|startoftext|>it's<|endoftext|>", "we'll've'd 'S'Ll", "x²³ ٣4 ⅷ", "!!!?..,,;", "ſ'ſ 'ſ",
    "ͅaͅ!ͅ", "日本語のテキスト", "emoji 😀👍🏽 mix", "&amp;lt;tag&amp;gt;",
]


def _tok(pkg, **kw):
    return pkg.SimpleTokenizer(str(BPE / "merges.txt"), **kw)


# ------------------------------------------------------------------ tokenizer

@pytest.mark.parametrize("text", STRINGS)
def test_tokenizer_ids_match_jax_on_the_fixture(text):
    assert _tok(pclip).encode(text) == _tok(jclip).encode(text)
    np.testing.assert_array_equal(_tok(pclip).tokenize([text, text[::-1]]),
                                  _tok(jclip).tokenize([text, text[::-1]]))


def test_split_words_is_the_jax_pattern():
    jt = _tok(jclip)
    for text in STRINGS:
        clean = jt._clean(text)
        assert pclip.split_words(clean) == jt.pat.findall(clean), text


_ASSIGNED = st.characters(exclude_categories=("Cs", "Cn"))
_TRICKY = st.sampled_from(list("'sStTrRvVmMlLdDeE ſͅ<|>!?.,0123456789²٣ⅷ") +
                          ["<|startoftext|>", "<|endoftext|>", "'ll", "'VE", "\t", "é", "ß"])


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.one_of(st.text(_ASSIGNED, max_size=40),
                 st.lists(_TRICKY, max_size=20).map("".join),
                 st.lists(st.one_of(_TRICKY, _ASSIGNED), max_size=20).map("".join)))
def test_tokenizer_ids_match_jax_on_generated_strings(text):
    assert _tok(pclip).encode(text) == _tok(jclip).encode(text)


def test_tokenizer_files_and_fallbacks_match_jax(monkeypatch):
    for s in STRINGS:
        assert pclip.SimpleTokenizer(str(BPE / "merges.txt.gz")).encode(s) == _tok(pclip).encode(s)
    vocab = json.loads((BPE / "vocab.json").read_text())
    assert (_tok(pclip).SOT, _tok(pclip).EOT) == (vocab["<|startoftext|>"], vocab["<|endoftext|>"])
    with pytest.warns(UserWarning, match="ignoring the file"):
        small = _tok(pclip, vocab=128)
    assert small.bpe is None and (small.SOT, small.EOT) == (126, 127)
    for pkg in (pclip, jclip):
        monkeypatch.setattr(pkg.SimpleTokenizer, "_find_standard_path", classmethod(lambda c: None))
    with pytest.raises(RuntimeError, match="BPE merges"):
        pclip.SimpleTokenizer().encode("hello")
    hashed = [pkg.SimpleTokenizer(allow_hash_fallback=True).tokenize(["hello world  x"])
              for pkg in (pclip, jclip)]
    np.testing.assert_array_equal(*hashed)
    monkeypatch.undo()   # the standard search again, with the variable set
    monkeypatch.setenv("ANYLOC_CLIP_BPE", str(BPE / "merges.txt"))
    assert pclip.SimpleTokenizer().bpe


# ------------------------------------------------------------------ text tower

def test_text_tower_matches_jax():
    tower = jclip.CLIPTextTower(vocab=300, width=32, heads=4, layers=2, context=77, embed_dim=24)
    toks = np.zeros((3, 77), np.int32)
    toks[0, :5] = [1, 7, 9, 2, 299]       # EOT = the highest id
    toks[1, :3] = [299, 4, 5]
    toks[2, :77] = np.arange(77) + 100
    params = jax.jit(tower.init)(jax.random.PRNGKey(0), jnp.asarray(toks))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        jax.device_get(params))
    want = jax.jit(tower.apply)(params, jnp.asarray(toks))
    port_tower = materialize(lambda: pclip.CLIPTextTower(vocab=300, width=32, heads=4, layers=2,
                                                         context=77, embed_dim=24),
                             pclip.from_jax_text_params(params), "cpu")
    with torch.no_grad():
        got = port_tower(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the wrapper

TINY = "ViT-T/16"


@pytest.fixture
def tiny_clip(monkeypatch, tmp_path):
    """ViT-T/16 in both packages (text vocabulary 600, so the fixture's BPE
    fits) and an OpenAI-layout checkpoint of it."""
    for mod in (jclip, pclip):
        monkeypatch.setitem(mod._VISION, TINY, (16, 128, 2, 2, 24, 32))
        monkeypatch.setitem(mod._TEXT, TINY, (77, 600, 32, 4, 2))
    model = pclip.ClipWrapper("openai", TINY, device="cpu", seed=0)
    sd = {**{"visual." + k: v for k, v in _openai_vision(model.vision).items()},
          **model.text.state_dict()}
    rng = np.random.default_rng(2)
    sd = {k: torch.from_numpy((v.numpy() + 0.05 * rng.standard_normal(v.shape)).astype(np.float32))
          for k, v in sd.items()}
    sd["logit_scale"] = torch.tensor(np.log(30.0), dtype=torch.float32)
    path = tmp_path / "clip_tiny.pt"
    torch.save(sd, path)
    return str(path)


def _openai_vision(vit):
    """The port's vision trunk in OpenAI's names (``convert_clip_vision``
    inverted)."""
    sd = vit.state_dict()
    out = {"conv1.weight": sd["patch_embed.proj.weight"],
           "class_embedding": sd["cls_token"].reshape(-1),
           "positional_embedding": sd["pos_embed"][0],
           "proj": sd["proj_out.weight"].t().contiguous()}
    for ours, theirs in (("norm_pre", "ln_pre"), ("norm", "ln_post")):
        for kind in ("weight", "bias"):
            out[f"{theirs}.{kind}"] = sd[f"{ours}.{kind}"]
    for i in range(len(vit.blocks)):
        b, h = f"blocks.{i}", f"transformer.resblocks.{i}"
        out[f"{h}.attn.in_proj_weight"] = sd[f"{b}.attn.qkv.weight"]
        out[f"{h}.attn.in_proj_bias"] = sd[f"{b}.attn.qkv.bias"]
        for ours, theirs in (("norm1", "ln_1"), ("norm2", "ln_2"), ("attn.proj", "attn.out_proj"),
                             ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            for kind in ("weight", "bias"):
                out[f"{h}.{theirs}.{kind}"] = sd[f"{b}.{ours}.{kind}"]
    return out


def _pair(ckpt, **kw):
    return (pclip.ClipWrapper("openai", TINY, checkpoint=ckpt, bpe_path=str(BPE / "merges.txt"),
                              device="cpu", **kw),
            jclip.ClipWrapper("openai", TINY, checkpoint=ckpt, bpe_path=str(BPE / "merges.txt"),
                              **kw))


def test_clip_wrapper_encodes_and_classifies_as_jax(tiny_clip):
    pm, jm = _pair(tiny_clip)
    assert pm.logit_scale == pytest.approx(jm.logit_scale)
    imgs = np.random.default_rng(3).standard_normal((2, 48, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(pm.encode_image(imgs).numpy(), np.asarray(jm.encode_image(imgs)),
                               atol=1e-5)
    texts = ["a photo of the city", "hello world", "the cat's hat"]
    np.testing.assert_allclose(pm.encode_text(texts, normalize=True).numpy(),
                               np.asarray(jm.encode_text(texts, normalize=True)), atol=1e-5)
    got = pm(imgs[0], texts, normalize=True)
    want = jm(imgs[0], texts, normalize=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert pm.list_models(ret_vals=True) == jm.list_models(ret_vals=True)


def test_clip_wrapper_caches_like_jax(tiny_clip, tmp_path):
    """The reference's per-item caches: ``.npz`` under
    experiments/<sub>/<impl>_<name>/images|text, read back for a cache id
    whatever the input."""
    pm, jm = _pair(tiny_clip, base_cache_dir=str(tmp_path), use_caching="exp1")
    img = np.random.default_rng(4).standard_normal((32, 32, 3)).astype(np.float32)
    first = pm.encode_image(img, ci="img0")
    again = pm.encode_image(np.zeros_like(img), ci="img0")
    np.testing.assert_array_equal(first.numpy(), again.numpy())
    # the JAX package reads the port's cache file (same directory and key)
    np.testing.assert_allclose(np.asarray(jm.encode_image(np.zeros_like(img), ci="img0")),
                               first.numpy(), atol=0)
    assert pathlib.Path(pm._cache_path("images", "img0")).exists()


# ------------------------------------------------------------------ the pipelines

def _fixture_datasets(size=(64, 64)):
    db = sorted(glob.glob(str(E2E / "db" / "*")))
    qu = sorted(glob.glob(str(E2E / "queries" / "*")))
    gt = list(np.load(E2E / "gt.npy", allow_pickle=True))
    return (port.VPRDataset(db, qu, soft_positives_per_query=gt, img_size=size),
            JaxVPRDataset(db, qu, soft_positives_per_query=gt, img_size=size))


@pytest.fixture
def pil_decode(monkeypatch):
    monkeypatch.setattr(port.VPRDataset, "use_native_loader", False)
    monkeypatch.setattr(JaxVPRDataset, "use_native_loader", False)


def _vocab(tmp_path, c=4, d=24):
    (tmp_path / "vocab").mkdir()
    np.savez(tmp_path / "vocab" / "c_centers.npz",
             centers=np.random.default_rng(5).standard_normal((c, d)).astype(np.float32))
    return str(tmp_path / "vocab")


def _largs(ckpt, extra=()):
    flags = ["--extractor.model-type", f"clip_{TINY}", "--extractor.checkpoint", ckpt,
             "--extractor.batch-size", "8", "--top-k-vals", "1", "3", "5", *extra]
    return parse_args(PipelineArgs, flags), jax_parse_args(JaxArgs, flags)


def _same_results(got, want):
    for k in ("Qual-Indices",):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    np.testing.assert_allclose(np.asarray(got["Qual-Dists"]), np.asarray(want["Qual-Dists"]),
                               atol=1e-5)
    assert {k: v for k, v in got.items() if not k.startswith(("Qual-", "Timestamp"))} == \
        {k: v for k, v in want.items() if not k.startswith(("Qual-", "Timestamp"))}


@pytest.mark.parametrize("pca_dim", [None, 8])
def test_run_clip_top_k_on_the_fixture_matches_jax(tiny_clip, pil_decode, pca_dim):
    pds, jds = _fixture_datasets()
    pl, jl = _largs(tiny_clip)
    got = ppipes.run_clip_top_k(pl, dataset=pds, pca_dim=pca_dim, device="cpu")
    want = jpipes.run_clip_top_k(jl, dataset=jds, pca_dim=pca_dim)
    if pca_dim is None:
        _same_results(got, want)
    else:   # PCA components agree up to sign: hold the recalls and distances
        assert {k: got[k] for k in got if k.startswith("R@")} == \
            {k: want[k] for k in want if k.startswith("R@")}
        np.testing.assert_allclose(np.asarray(got["Qual-Dists"]), np.asarray(want["Qual-Dists"]),
                                   atol=1e-4)


def test_run_patch_clip_on_the_fixture_matches_jax(tiny_clip, pil_decode, tmp_path):
    """Half-overlapping crops of 64 px images (3 x 3 of 32 px), each through
    CLIP, VLAD over one shared vocabulary (F2: neither package can draw
    the other's k-means start)."""
    pds, jds = _fixture_datasets()
    pl, jl = _largs(tiny_clip, ["--vlad.num-clusters", "4", "--vlad.cache-dir", _vocab(tmp_path)])
    got = ppipes.run_patch_clip(pl, dataset=pds, device="cpu")
    want = jpipes.run_patch_clip(jl, dataset=jds)
    _same_results(got, want)
    imgs = np.random.default_rng(6).standard_normal((2, 64, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(ppipes.unfold_crops(imgs, 4), jpipes.unfold_crops(imgs, 4))


def test_trivial_clip_vpr_on_the_fixture_matches_jax(tiny_clip, tmp_path):
    """Per-image CLIP descriptors of the fixture's JPEGs (natural order,
    stride 2), cosine k-means from the JAX package's start rows (F2), the
    images copied into per-cluster folders."""
    from PIL import Image

    pm, jm = _pair(tiny_clip)
    files = sorted(glob.glob(str(E2E / "db" / "*")))
    prep = pm.get_preprocessing(disable_prep=False)

    def encode(pkg_model):
        return lambda f: pkg_model.encode_image(prep(Image.open(f)), normalize=True)

    want_d, want_l = jextras.trivial_clip_vpr(files, encode(jm), stride=2, n_clusters=3,
                                              feat_dir=str(tmp_path / "jax_feats"))
    start = np.asarray(jax.random.choice(jax.random.PRNGKey(0), len(want_d), shape=(3,),
                                         replace=False))
    got_d, got_l = extras.trivial_clip_vpr(files, encode(pm), stride=2, n_clusters=3,
                                           feat_dir=str(tmp_path / "feats"),
                                           save_dir=str(tmp_path / "groups"),
                                           init_centers=np.asarray(want_d)[start], device="cpu")
    np.testing.assert_allclose(got_d, np.asarray(want_d), atol=1e-5)
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
    assert len(glob.glob(str(tmp_path / "groups" / "*" / "*"))) == len(got_l)
    # a second run reads the cached vectors
    again, _ = extras.trivial_clip_vpr(files, lambda f: 1 / 0, stride=2, n_clusters=3,
                                       feat_dir=str(tmp_path / "feats"),
                                       init_centers=np.asarray(want_d)[start], device="cpu")
    np.testing.assert_array_equal(again, got_d)


@pytest.mark.parametrize("cmd", ["clip-top-k", "patch-clip"])
def test_cli_clip_subcommands_match_jax(tiny_clip, pil_decode, tmp_path, cmd):
    """``cli.main([cmd, ...], device="cpu")`` against ``anyloc_tpu.cli.main``
    on one 17places tree: the saved results JSONs agree but ``Timestamp``."""
    root = tmp_path / "data"
    jax_synthetic.build_vpr_bench(str(root), n_db=8, n_q=4, seed=1, size=(60, 80))
    vocab = _vocab(tmp_path)
    outs = []
    for main, out in ((lambda a: cli.main(a, device="cpu"), "port"), (jax_cli.main, "jax")):
        args = [cmd, "--prog.data-vg-dir", str(root), "--prog.vg-dataset-name", "17places",
                "--prog.cache-dir", str(tmp_path / out), "--exp-id", "e",
                "--extractor.model-type", f"clip_{TINY}", "--extractor.checkpoint", tiny_clip,
                "--bd-args.resize", "64", "64", "--vlad.num-clusters", "4",
                "--vlad.cache-dir", vocab, "--top-k-vals", "1", "3"]
        assert main(args) == 0
        (path,) = glob.glob(str(tmp_path / out / "experiments" / "e" / "results_*.json"))
        outs.append({k: v for k, v in json.loads(pathlib.Path(path).read_text()).items()
                     if k != "Timestamp"})
    assert outs[0] == outs[1]


def test_lseg_text_tower_and_logit_scale_match_jax(tiny_clip):
    """The CLIP text tower inside a lang-seg checkpoint (``net.`` +
    ``clip_pretrained.*``) through both ``convert_lseg_text``, and its
    logit scale."""
    from anyloc_tpu.models import lseg as jlseg
    from anyloc_tpu_torch.models import lseg as plseg

    sd = {f"net.clip_pretrained.{k}": v for k, v in torch.load(tiny_clip).items()}
    assert plseg.lseg_logit_scale(sd) == jlseg.lseg_logit_scale(sd) == 1.0   # none at the top
    sd["net.logit_scale"] = torch.tensor(np.log(30.0), dtype=torch.float32)
    tower = dict(vocab=600, width=32, heads=4, layers=2, context=77, embed_dim=24)
    toks = _tok(pclip).tokenize(["a photo of the city", "hello world"])
    want = jclip.CLIPTextTower(**tower).apply(jlseg.convert_lseg_text(sd, 2), jnp.asarray(toks))
    port_tower = materialize(lambda: pclip.CLIPTextTower(**tower), plseg.convert_lseg_text(sd, 2),
                             "cpu")
    with torch.no_grad():
        got = port_tower(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert plseg.lseg_logit_scale(sd) == pytest.approx(jlseg.lseg_logit_scale(sd)) == \
        pytest.approx(30.0)
