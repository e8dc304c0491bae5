"""The port's descriptor cache (``utils/desc_cache.py``) and the engine
that uses it, against the JAX package's, on the CPU.

The five cases of ``tests/test_desc_cache.py`` run against both classes;
a cache written by either package is read by the other, shard by shard
and through the engines; F3's race on stale shards and F12's argument
order are shown by tests of their own.
"""

import inspect
import os
import pathlib

import numpy as np
import pytest
import torch

from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.models.dinov2 import convert_dinov2
from anyloc_tpu.models.extractor import ViTFacetExtractor as JaxExtractor
from anyloc_tpu.ops.vlad import VLAD as JaxVLAD
from anyloc_tpu.pipelines.engine import DescriptorEngine as JaxEngine
from anyloc_tpu.utils.desc_cache import DescriptorCache as JaxCache

import anyloc_tpu_torch as port
from anyloc_tpu_torch.utils.desc_cache import DescriptorCache as PortCache

from test_torch_slice import _configs, _mini_state_dict

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "e2e"
CLASSES = pytest.mark.parametrize("cls", [JaxCache, PortCache], ids=["jax", "port"])


@CLASSES
def test_roundtrip_and_header_only_has(tmp_path, cls):
    cache = cls(str(tmp_path), {"m": "x"}, shard_size=4)
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    assert not cache.has("db", 10)
    np.testing.assert_array_equal(cache.get_or_compute("db", 10, lambda: x), x)
    assert cache.has("db", 10)
    np.testing.assert_array_equal(cache.read("db", 10), x)


@CLASSES
def test_torn_shard_is_a_miss_not_a_crash(tmp_path, cls):
    cache = cls(str(tmp_path), {"m": "x"}, shard_size=4)
    x = np.ones((10, 3), np.float32)
    cache.write("db", x)
    p = cache._shard_path("db", 1)
    raw = pathlib.Path(p).read_bytes()
    pathlib.Path(p).write_bytes(raw[: len(raw) // 2])
    assert not cache.has("db", 10)
    np.testing.assert_array_equal(cache.get_or_compute("db", 10, lambda: 2 * x), 2 * x)
    assert cache.has("db", 10)


@CLASSES
def test_shorter_rewrite_removes_stale_shards(tmp_path, cls):
    cache = cls(str(tmp_path), {"m": "x"}, shard_size=4)
    cache.write("db", np.ones((10, 3), np.float32))
    cache.write("db_2", np.ones((10, 3), np.float32))   # a key that extends "db"
    cache.write("db", np.full((5, 3), 7, np.float32))
    assert not os.path.exists(cache._shard_path("db", 2))
    assert cache.has("db", 5) and not cache.has("db", 10)
    assert cache.has("db_2", 10)
    np.testing.assert_array_equal(cache.read("db", 5), np.full((5, 3), 7, np.float32))


@CLASSES
def test_shard_size_is_part_of_identity(tmp_path, cls):
    a = cls(str(tmp_path), {"m": "x"}, shard_size=2)
    b = cls(str(tmp_path), {"m": "x"}, shard_size=4)
    assert a.dir != b.dir


@CLASSES
def test_zero_items_and_short_compute(tmp_path, cls):
    cache = cls(str(tmp_path), {"m": "x"}, shard_size=4)
    assert not cache.has("q", 0)
    with pytest.raises(ValueError):
        cache.get_or_compute("q", 10, lambda: np.ones((8, 3), np.float32))
    cache.write("q", np.ones((3, 3), np.float32))
    assert not cache.has("q", 10)


def test_a_stale_shard_another_writer_removed_is_no_error(tmp_path, monkeypatch):
    """F3: the JAX class checks that a stale shard exists, then removes it;
    when another writer removes it in between, its write raises. The
    port's does not, and still removes every stale shard."""
    real_remove = os.remove

    def raced(cls):
        cache = cls(str(tmp_path / cls.__module__), {"m": "x"}, shard_size=4)
        cache.write("db", np.ones((10, 3), np.float32))   # shards 0, 1, 2
        raced_once = []

        def remove(path):
            real_remove(path)   # the other writer got there first
            if not raced_once:
                raced_once.append(path)
                raise FileNotFoundError(path)

        monkeypatch.setattr(os, "remove", remove)
        try:
            cache.write("db", np.full((3, 3), 5, np.float32))   # shard 0 only
        finally:
            monkeypatch.setattr(os, "remove", real_remove)
        assert raced_once
        return cache

    with pytest.raises(FileNotFoundError):
        raced(JaxCache)
    cache = raced(PortCache)
    assert not any(os.path.exists(cache._shard_path("db", s)) for s in (1, 2))
    np.testing.assert_array_equal(cache.read("db", 3), np.full((3, 3), 5, np.float32))


@pytest.mark.parametrize("writer,reader", [(JaxCache, PortCache), (PortCache, JaxCache)],
                         ids=["jax-writes", "port-writes"])
def test_either_package_reads_the_others_cache(tmp_path, writer, reader):
    cfg = {"model": "dinov2_vitg14", "layer": 31, "facet": "value", "checkpoint": None}
    x = np.random.default_rng(0).standard_normal((9, 5)).astype(np.float32)
    w = writer(str(tmp_path), cfg, shard_size=4)
    w.write("k", x)
    r = reader(str(tmp_path), cfg, shard_size=4)
    assert r.dir == w.dir and r.has("k", 9)
    np.testing.assert_array_equal(r.get_or_compute("k", 9, lambda: 0 * x), x)


# ------------------------------------------------------------ the engine

def _fixture_paths():
    return (port.listdir_abs(str(FIXTURE), "db"), port.listdir_abs(str(FIXTURE), "queries"),
            list(np.load(FIXTURE / "gt.npy", allow_pickle=True)))


class CountingExtractor(port.ViTFacetExtractor):
    """Counts its forwards, so a test sees whether a call computed."""

    calls = 0

    def __call__(self, imgs):
        type(self).calls += 1
        return super().__call__(imgs)


@pytest.fixture
def engine_factory(tmp_path):
    _, pcfg = _configs(64, 2, 4, 56)
    sd = _mini_state_dict(12, depth=2)

    def make(cache=True):
        ext = CountingExtractor(pcfg, sd, 1, "value", device="cpu")
        return port.DescriptorEngine(batch_size=4, extractor=ext,
                                     cache_dir=str(tmp_path / "cache") if cache else None)
    return make


def _vlad(descs, nc=4, seed=0):
    v = port.VLAD(nc)
    v.c_centers = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((nc, descs)).astype(np.float32))
    return v


def test_engine_with_a_cache_computes_nothing_the_second_time(engine_factory):
    db, qu, gt = _fixture_paths()
    ds = port.VPRDataset(db[:6], qu[:3], gt[:3], img_size=(56, 56))
    vlad = _vlad(64)
    first = engine_factory()
    CountingExtractor.calls = 0
    d1 = first.extract_dataset(ds, "db", verbose=False)
    v1 = first.extract_vlads_dataset(ds, vlad, "queries", verbose=False)
    assert CountingExtractor.calls == 2 + 1
    second = engine_factory()
    d2 = second.extract_dataset(ds, "db", verbose=False)
    v2 = second.extract_vlads_dataset(ds, vlad, "queries", verbose=False)
    assert CountingExtractor.calls == 3
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(v1, v2)
    # keep_on_device bypasses the cache, as in the JAX package
    on_dev = second.extract_dataset(ds, "db", verbose=False, keep_on_device=True)
    assert CountingExtractor.calls == 5 and isinstance(on_dev, torch.Tensor)
    # the same VLADs as an engine without a cache
    plain = engine_factory(cache=False).extract_vlads_dataset(ds, vlad, "queries", verbose=False)
    np.testing.assert_array_equal(v1, plain)


def test_engine_cache_keys_follow_the_dataset_size_aggregation_and_vocabulary(engine_factory):
    db, qu, gt = _fixture_paths()
    ds = port.VPRDataset(db[:6], qu[:3], gt[:3], img_size=(56, 56))
    eng = engine_factory()
    key = eng._cache_key
    idx = ds.indices("db")
    base = key(ds, "db", 1, idx)
    assert key(port.VPRDataset(db[1:7], qu[:3], img_size=(56, 56)), "db", 1, idx) != base
    assert key(port.VPRDataset(db[:6], qu[:3], img_size=(70, 70)), "db", 1, idx) != base
    assert key(ds, "db", 2, idx[::2]) != base
    CountingExtractor.calls = 0
    eng.extract_vlads_dataset(ds, _vlad(64, seed=0), "queries", verbose=False)
    eng.extract_vlads_dataset(ds, _vlad(64, seed=0), "queries", verbose=False)
    assert CountingExtractor.calls == 1
    eng.extract_vlads_dataset(ds, _vlad(64, seed=1), "queries", verbose=False)   # new vocabulary
    assert CountingExtractor.calls == 2
    v = _vlad(64, seed=1)
    v.vlad_mode = "soft"                                    # new aggregation settings
    eng.extract_vlads_dataset(ds, v, "queries", verbose=False)
    assert CountingExtractor.calls == 3
    eng.extract_aggregated_dataset(ds, lambda f: f.mean(1), "mean", "queries", verbose=False)
    eng.extract_aggregated_dataset(ds, lambda f: f.amax(1), "max", "queries", verbose=False)
    assert CountingExtractor.calls == 5
    names = os.listdir(eng.desc_cache.dir)
    assert any(n.startswith("mean_VPRDataset_queries_ss1_") for n in names)
    assert any(n.startswith("max_VPRDataset_queries_ss1_") for n in names)


def test_extract_aggregated_dataset_takes_agg_key_in_the_jax_position(engine_factory):
    """F12: (dataset, aggregate, agg_key, which, sub_sample, verbose), as in
    the JAX package; a JAX-style positional call selects the queries."""
    names = list(inspect.signature(port.DescriptorEngine.extract_aggregated_dataset).parameters)
    assert names == list(inspect.signature(JaxEngine.extract_aggregated_dataset).parameters)
    db, qu, gt = _fixture_paths()
    ds = port.VPRDataset(db[:6], qu[:3], gt[:3], img_size=(56, 56))
    for cached in (False, True):
        out = engine_factory(cache=cached).extract_aggregated_dataset(
            ds, lambda f: f.mean(1), "mean", "queries", 1, False)
        assert out.shape == (3, 64)


def test_the_engines_read_each_others_vlad_cache(tmp_path, monkeypatch):
    """The JAX engine writes VLADs of the fixture into a cache, and the
    port's engine over the same config, dataset and vocabulary reads them
    without computing; then the other way round."""
    db, qu, gt = _fixture_paths()
    sd = _mini_state_dict(13, depth=2)
    jcfg, pcfg = _configs(64, 2, 4, 56)
    rng = np.random.default_rng(4)
    vdir = tmp_path / "vocab"
    vdir.mkdir()
    np.savez(vdir / "c_centers.npz", centers=rng.standard_normal((4, 64)).astype(np.float32))
    jvlad, pvlad = JaxVLAD(4, cache_dir=str(vdir)), port.VLAD(4, cache_dir=str(vdir))
    jvlad.fit(None)
    pvlad.fit(None)
    assert jvlad.vocab_key() == pvlad.vocab_key()
    kw = dict(model_type="mini", desc_layer=1, batch_size=4)
    for side in ("jax-writes", "port-writes"):
        cache = str(tmp_path / side)
        jeng = JaxEngine(extractor=JaxExtractor(jcfg, convert_dinov2(sd, jcfg), 1, "value"),
                         cache_dir=cache, **kw)
        peng = port.DescriptorEngine(extractor=port.ViTFacetExtractor(pcfg, sd, 1, "value",
                                                                      device="cpu"),
                                     cache_dir=cache, **kw)
        assert jeng.desc_cache.dir == peng.desc_cache.dir
        jds = JaxVPRDataset(db[:5], qu[:3], gt[:3], img_size=(56, 56))
        jds.use_native_loader = False
        pds = port.VPRDataset(db[:5], qu[:3], gt[:3], img_size=(56, 56))
        writer, reader = (jeng, peng) if side == "jax-writes" else (peng, jeng)
        wds, rds = (jds, pds) if side == "jax-writes" else (pds, jds)
        wvlad, rvlad = (jvlad, pvlad) if side == "jax-writes" else (pvlad, jvlad)
        wrote = np.asarray(writer.extract_vlads_dataset(wds, wvlad, "db", verbose=False))

        def no_compute(*a, **k):
            raise AssertionError("the reader computed instead of reading the cache")

        monkeypatch.setattr(reader, "_extract_dataset", no_compute)
        read = np.asarray(reader.extract_vlads_dataset(rds, rvlad, "db", verbose=False))
        np.testing.assert_array_equal(read, wrote)
        assert wrote.shape == (5, 4 * 64)
