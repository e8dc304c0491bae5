"""The port's dataset layer against the JAX package's: the registry and
every loader on the JAX package's synthetic trees, the query test
methods, the global vocabulary dataset, the format helpers of
``data/tools.py``, the synthetic tree writers and the native image pipe.

Both packages decode through PIL for the loader checks, so batches agree
exactly; the native pipe is held bit-equal to the JAX package's build of
the same source, and to PIL within ``tests/test_imagepipe.py``'s bounds.
"""

import os
import pathlib

import numpy as np
import pytest
from PIL import Image

from anyloc_tpu import native as jax_native
from anyloc_tpu.data import registry as jax_registry
from anyloc_tpu.data.base import VPRDataset as JaxVPRDataset
from anyloc_tpu.data import synthetic as jax_synthetic
from anyloc_tpu.data import tools as jax_tools
from anyloc_tpu.data.loaders.base_dataset import BaseDataset as JaxBaseDataset
from anyloc_tpu.data.loaders.global_vocab import GlobalVocabDataset as JaxGlobalVocab

from anyloc_tpu_torch import native as port_native
from anyloc_tpu_torch.data import registry as port_registry
from anyloc_tpu_torch.data import synthetic as port_synthetic
from anyloc_tpu_torch.data import tools as port_tools
from anyloc_tpu_torch.data.base import VPRDataset
from anyloc_tpu_torch.data.loaders.base_dataset import TEST_METHODS
from anyloc_tpu_torch.data.loaders.base_dataset import BaseDataset as PortBaseDataset
from anyloc_tpu_torch.data.loaders.global_vocab import GlobalVocabDataset as PortGlobalVocab

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "e2e"
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


def _vpair(root, n_db=6, n_q=3, n_dis=4, seed=0):
    """VP-Air layout (no builder in data/synthetic.py): reference_views/,
    queries/, distractors/ and vpair_gt.npy."""
    rng = np.random.default_rng(seed)
    db, qs, gt = jax_synthetic.make_image_pairs(rng, n_db + n_dis, n_q)
    ds = os.path.join(root, "VPAir")
    for sub, arrs in (("reference_views", db[:n_db]), ("queries", qs),
                      ("distractors", db[n_db:])):
        for i, a in enumerate(arrs):
            jax_synthetic._write_img(os.path.join(ds, sub, f"{i:05d}.png"), a)
    gt_arr = np.empty((n_q, 2), object)
    for i, g in enumerate(gt):
        gt_arr[i] = (i, np.array([g % n_db]))
    np.save(os.path.join(ds, "vpair_gt.npy"), gt_arr, allow_pickle=True)
    return root


# every name the registry knows -> the tree that name reads
TREES = {
    "st_lucia": lambda r: jax_synthetic.build_vg_bench(r, name="st_lucia"),
    "pitts30k": lambda r: jax_synthetic.build_vg_bench(r, name="pitts30k"),
    "nordland": lambda r: jax_synthetic.build_vg_bench(r, name="nordland"),
    "tokyo247": lambda r: jax_synthetic.build_vg_bench(r, name="tokyo247"),
    "17places": lambda r: jax_synthetic.build_vpr_bench(r),
    "baidu_datasets": lambda r: jax_synthetic.build_baidu(r),
    "Oxford": lambda r: jax_synthetic.build_oxford(r),
    "Oxford_25m": lambda r: jax_synthetic.build_oxford(r),
    "gardens": lambda r: jax_synthetic.build_gardens(r),
    "hawkins": lambda r: jax_synthetic.build_pose_split(r),
    "hawkins_long_corridor": lambda r: jax_synthetic.build_pose_split(r),
    "VPAir": _vpair,
    "VPAir_distractor": _vpair,
    "Tartan_GNSS_rotated": lambda r: jax_synthetic.build_aerial(r, name="Tartan_GNSS_rotated"),
    "Tartan_GNSS_notrotated": lambda r: jax_synthetic.build_aerial(r, name="Tartan_GNSS_notrotated"),
    "Tartan_GNSS_test_notrotated": lambda r: jax_synthetic.build_aerial(
        r, name="Tartan_GNSS_test_notrotated"),
    "Tartan_GNSS_test_rotated": lambda r: jax_synthetic.build_aerial(
        r, name="Tartan_GNSS_test_rotated"),
    "laurel_caverns": lambda r: jax_synthetic.build_pose_split(r, name="laurel_caverns", n_db=9, n_q=5),
    "eiffel": lambda r: jax_synthetic.build_eiffel(r),
    "NVL_datasets": lambda r: jax_synthetic.build_naverlabs(r),
}


def _positives(ds):
    pos = ds.get_positives()
    return None if pos is None else [np.asarray(p, np.int64).tolist() for p in pos]


def _first_batch(ds, output="float32"):
    ds.use_native_loader = False
    return next(iter(ds.batches(4, output=output)))


def test_every_registry_name_has_a_tree():
    assert set(port_registry.dataset_names()) <= set(TREES)
    assert port_registry.dataset_names() == jax_registry.dataset_names()


@pytest.mark.parametrize("name", sorted(TREES))
def test_loader_matches_jax(tmp_path, name):
    """Same paths, counts, positives, cache ids and first batch (f32 and
    uint8, PIL on both sides: exact)."""
    root = TREES[name](str(tmp_path))
    want = jax_registry.get_dataset(name, root, img_size=(48, 56))
    got = port_registry.get_dataset(name, root, img_size=(48, 56))
    assert type(got).__name__ == type(want).__name__
    assert got.images_paths == want.images_paths
    assert (got.database_num, got.queries_num) == (want.database_num, want.queries_num)
    assert got.database_num > 0
    assert _positives(got) == _positives(want)
    for attr in ("soft_positives_per_db", "loc_rad", "db_utms", "qu_utms",
                 "database_utms", "queries_utms"):
        a, b = getattr(got, attr, None), getattr(want, attr, None)
        if isinstance(b, list):
            assert [x.tolist() for x in a] == [x.tolist() for x in b], attr
        else:
            np.testing.assert_array_equal(a, b, err_msg=attr)
    ids = list(range(len(want)))
    assert got.get_image_relpaths(ids) == want.get_image_relpaths(ids)
    assert got.get_image_relpaths(0) == want.get_image_relpaths(0)
    # uint8 against the JAX package's standard loader over the same paths:
    # its BaseDataset refuses raw bytes even for hard_resize items (F13)
    plain = JaxVPRDataset(want.db_paths, want.query_paths, img_size=(48, 56))
    for output, ref in (("float32", want), ("uint8", plain)):
        (gi, gx), (wi, wx) = _first_batch(got, output), _first_batch(ref, output)
        assert gi.dtype == wi.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gx, wx)


@pytest.mark.parametrize("method", TEST_METHODS)
def test_query_test_method_matches_jax(tmp_path, method):
    root = jax_synthetic.build_vg_bench(str(tmp_path), n_db=4, n_q=2, size=(48, 72))
    want = JaxBaseDataset(root, "pitts30k", "test", img_size=(40, 44), test_method=method)
    got = PortBaseDataset(root, "pitts30k", "test", img_size=(40, 44), test_method=method)
    for i in (0, want.database_num, want.database_num + 1):
        np.testing.assert_array_equal(got[i][0], want[i][0])
    if method != "hard_resize":
        with pytest.raises(ValueError, match="uint8"):
            next(iter(got.batches(2, output="uint8")))


def test_hard_resize_items_take_the_native_pipe_and_raw_bytes(tmp_path):
    """F13: the JAX package's BaseDataset overrides __getitem__ for its
    query test methods, and so refuses uint8 batches and never decodes
    natively, even for hard_resize, whose items are load_image of their
    paths. The port's BaseDataset takes both there."""
    root = jax_synthetic.build_vpr_bench(str(tmp_path), n_db=4, n_q=2)
    want = JaxBaseDataset(root, "17places", img_size=(40, 44))
    with pytest.raises(ValueError, match="uint8"):
        next(iter(want.batches(2, output="uint8")))
    got = PortBaseDataset(root, "17places", img_size=(40, 44))
    plain = VPRDataset(got.db_paths, got.query_paths, img_size=(40, 44))
    assert got.decoder() == plain.decoder()
    for output in ("float32", "uint8"):
        np.testing.assert_array_equal(next(iter(got.batches(6, output=output)))[0],
                                      next(iter(plain.batches(6, output=output)))[0])
    assert PortBaseDataset(root, "17places", test_method="five_crops").decoder() == "PIL"


def test_unknown_test_method_raises(tmp_path):
    root = jax_synthetic.build_vg_bench(str(tmp_path), n_db=2, n_q=1)
    with pytest.raises(ValueError, match="test_method"):
        PortBaseDataset(root, "pitts30k", test_method="ten_crops")


def test_global_vocab_dataset_from_a_recipe_matches_jax(tmp_path):
    root = str(tmp_path)
    for name in ("baidu_datasets", "gardens", "17places"):
        TREES[name](root)
    want = JaxGlobalVocab.from_domain("indoor", root, img_size=(48, 48))
    got = PortGlobalVocab.from_domain("indoor", root, img_size=(48, 48))
    assert got.images_paths == want.images_paths
    assert got.db_stat == want.db_stat == {"baidu_datasets": 8, "gardens": 8, "17places": 10}
    assert got.queries_num == 0 and got.get_positives() is None
    mixed = PortGlobalVocab(["gardens", "17places"], root, ss_list=[2, 3], img_size=(48, 48))
    assert mixed.db_stat == JaxGlobalVocab(["gardens", "17places"], root, ss_list=[2, 3],
                                           img_size=(48, 48)).db_stat == {"gardens": 4, "17places": 4}
    np.testing.assert_array_equal(_first_batch(got)[0], _first_batch(want)[0])


def test_domain_recipes_match_jax():
    assert port_registry.DOMAIN_RECIPES == jax_registry.DOMAIN_RECIPES
    assert list(port_registry.DOMAIN_RECIPES) == list(jax_registry.DOMAIN_RECIPES)


# ------------------------------------------------------------ data/tools.py

LATLON = [(40.44, -79.99), (35.681, 139.761), (-33.86, 151.21), (64.1, -21.9),
          (0.0, 0.0), (-0.5, 179.9)]


@pytest.mark.parametrize("lat,lon", LATLON)
def test_utm_helpers_match_jax(lat, lon):
    want = jax_tools.latlon_to_utm(lat, lon)
    assert port_tools.latlon_to_utm(lat, lon) == want
    e, n, zone, letter = want
    assert port_tools.utm_to_latlon(e, n, zone, letter) == jax_tools.utm_to_latlon(e, n, zone, letter)
    name = port_tools.build_utm_filename(e, n, heading=12.5, timestamp="2020", note="x")
    assert name == jax_tools.build_utm_filename(e, n, heading=12.5, timestamp="2020", note="x")
    assert port_tools.parse_utm_filename(name) == jax_tools.parse_utm_filename(name)
    kw = dict(pano_id="p1", tile_num=3, heading=90, pitch=5, timestamp="20200101_1200", note="n")
    assert (port_tools.get_dst_image_name(lat, lon, **kw)
            == jax_tools.get_dst_image_name(lat, lon, **kw))
    assert port_tools.get_distance((e, n), (lat, lon)) == jax_tools.get_distance((e, n), (lat, lon))


@pytest.mark.parametrize("ts", ["", "2020", "20200101", "20200101_12", "20200101_123456",
                                "2020011", "20200101_1234567", "x"])
def test_is_valid_timestamp_matches_jax(ts):
    assert port_tools.is_valid_timestamp(ts) == jax_tools.is_valid_timestamp(ts)


@pytest.mark.parametrize("num,left,right", [(1.1, 3, 3), (-0.5, 3, 5), (123.456789, 4, 2),
                                            (-9.999999, 2, 5), (0, 2, 5)])
def test_format_coord_matches_jax(num, left, right):
    assert port_tools.format_coord(num, left, right) == jax_tools.format_coord(num, left, right)


def test_format_helpers_raise_where_jax_asserts():
    with pytest.raises(ValueError, match="YYYYMMDD"):
        port_tools.get_dst_image_name(1.0, 2.0, timestamp="2020x")
    with pytest.raises(ValueError, match="roll"):
        port_tools.get_dst_image_name(1.0, 2.0, roll=3)


def _tree(root):
    """{relative path: bytes} of every file under root (links by target)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = pathlib.Path(p).read_bytes()
    return out


def _save_jpg(path, size=(32, 40)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.new("RGB", size, (120, 90, 60)).save(path)


def _cellcol(fns):
    arr = np.empty((len(fns), 1), object)
    arr[:, 0] = [np.array([f]) for f in fns]
    return arr


def _db_struct(db_fns, db_utm, q_fns, q_utm):
    return np.array(
        [("x", _cellcol(db_fns), db_utm, _cellcol(q_fns), q_utm,
          len(db_fns), len(q_fns), 25, 0, 0)],
        dtype=[("whichSet", "O"), ("dbImageFns", "O"), ("utmDb", "O"),
               ("qImageFns", "O"), ("utmQ", "O"), ("numImages", "O"),
               ("numQueries", "O"), ("posDistThr", "O"),
               ("posDistSqThr", "O"), ("nonTrivPosDistSqThr", "O")])


def _raw_mapillary(raw):
    for city in ("london", "cph"):
        for folder in ("database", "query"):
            d = os.path.join(raw, city, folder)
            rows_raw, rows_post = ["hdr\n"], ["hdr\n"]
            for i in range(3):
                pid = f"{city}{folder}{i}"
                rows_raw.append(f"k,{pid},-0.12,51.50,x,2020-01-0{i + 1},{i == 2}\n")
                rows_post.append(f"a,b,{i == 1},Forward\n")
                _save_jpg(os.path.join(d, "images", f"{pid}.jpg"))
            pathlib.Path(d, "raw.csv").write_text("".join(rows_raw))
            pathlib.Path(d, "postprocessed.csv").write_text("".join(rows_post))


def _raw_pitts250k(raw):
    import scipy.io as sio

    os.makedirs(os.path.join(raw, "datasets"))
    e0, n0, _, _ = jax_tools.latlon_to_utm(40.44, -79.99)
    for split in ("train", "val", "test"):
        db = [f"000/00{i}{split[0]}_pitch1_yaw{i + 1}.jpg" for i in range(2)]
        qs = [f"q0{split[0]}_pitch2_yaw1.jpg"]
        for f in db:
            _save_jpg(os.path.join(raw, f))
        for f in qs:
            _save_jpg(os.path.join(raw, "queries_real", f))
        utm = np.array([[e0 + i, n0 + i] for i in range(2)]).T
        sio.savemat(os.path.join(raw, "datasets", f"pitts250k_{split}.mat"),
                    {"dbStruct": _db_struct(db, utm, qs, utm[:, :1])})


def _raw_tokyo247(raw):
    import scipy.io as sio

    os.makedirs(os.path.join(raw, "datasets"))
    e0, n0, _, _ = jax_tools.latlon_to_utm(35.68, 139.76)
    db = ["03814/ABCDEFGHIJKLMNOPQRSTUV_012_030.jpg", "03814/ABCDEFGHIJKLMNOPQRSTUV_012_330.jpg"]
    for f in db:
        _save_jpg(os.path.join(raw, "tokyo247", f.replace(".jpg", ".png")))
    sio.savemat(os.path.join(raw, "datasets", "tokyo247.mat"),
                {"dbStruct": _db_struct(db, np.array([[e0, n0], [e0 + 5, n0 + 5]]).T,
                                        [], np.array([[], []]))})
    qdir = os.path.join(raw, "tokyo247", "247query_subset_v2")
    _save_jpg(os.path.join(qdir, "q0.jpg"), size=(600, 900))
    pathlib.Path(qdir, "q0.csv").write_text("qpano0,35.681,139.761,meta\n")


@pytest.mark.parametrize("fmt,raw_tree", [("format_mapillary", _raw_mapillary),
                                          ("format_pitts250k", _raw_pitts250k),
                                          ("format_tokyo247", _raw_tokyo247)])
def test_format_writes_the_same_tree_as_jax(tmp_path, fmt, raw_tree):
    """Each formatter on its own copy of one raw tree (mapillary moves its
    files): the same count and byte-equal output trees."""
    outs = {}
    for side, mod in (("jax", jax_tools), ("port", port_tools)):
        raw = str(tmp_path / side / "raw")
        raw_tree(raw)
        out = str(tmp_path / side / "out")
        outs[side] = (getattr(mod, fmt)(raw, out), _tree(out))
    assert outs["port"][0] == outs["jax"][0] > 0
    assert outs["port"][1] == outs["jax"][1]


def test_format_image_dir_and_map_match_jax(tmp_path):
    coords = [(40.44, -79.99), (40.45, -79.98), (40.46, -79.97)]
    trees = {}
    for side, mod in (("jax", jax_tools), ("port", port_tools)):
        src, qsrc = tmp_path / side / "src", tmp_path / side / "qsrc"
        for i in range(3):
            _save_jpg(str(src / f"img{i}.jpg"))
            _save_jpg(str(qsrc / f"q{i}.jpg"), size=(20, 30))
        ds = tmp_path / side / "ds" / "images" / "test"
        out = mod.format_image_dir(str(src), str(ds / "database"), coords, is_latlon=True)
        mod.format_image_dir(str(qsrc), str(ds / "queries"), coords[::-1], is_latlon=True,
                             move=True)
        png = mod.build_map_from_dataset(str(tmp_path / side / "ds"))
        trees[side] = ([os.path.basename(p) for p in out], _tree(str(ds)),
                       np.asarray(Image.open(png)))
    assert trees["port"][0] == trees["jax"][0]
    assert trees["port"][1] == trees["jax"][1]
    np.testing.assert_array_equal(trees["port"][2], trees["jax"][2])
    with pytest.raises(ValueError, match="coordinates"):
        port_tools.format_image_dir(str(tmp_path / "port" / "src"), str(tmp_path / "x"), coords[:1])


# ------------------------------------------------------------ data/synthetic.py

BUILDERS = ["build_gardens", "build_pose_split", "build_vg_bench", "build_vpr_bench",
            "build_aerial", "build_eiffel", "build_oxford", "build_naverlabs", "build_baidu"]


@pytest.mark.parametrize("builder", BUILDERS)
def test_synthetic_trees_are_byte_equal(tmp_path, builder):
    """The same seed writes the same files; a .mat file is compared past
    its 116-byte text header, which carries the time of writing."""
    kw = dict(seed=3, size=(40, 48))
    if builder == "build_pose_split":
        kw.update(n_db=12, n_q=5)
    getattr(jax_synthetic, builder)(str(tmp_path / "jax"), **kw)
    getattr(port_synthetic, builder)(str(tmp_path / "port"), **kw)
    want, got = _tree(str(tmp_path / "jax")), _tree(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) and len(want) > 3
    for rel in want:
        skip = 116 if rel.endswith(".mat") else 0
        assert got[rel][skip:] == want[rel][skip:], rel


# ------------------------------------------------------------ native image pipe

@pytest.fixture
def natives():
    if not port_native.imagepipe_available():
        pytest.skip("the native image pipe does not build here (g++, libjpeg, libpng)")
    if not jax_native.imagepipe_available():
        pytest.skip("the JAX package's native image pipe does not build here")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    img = (rng.random((96, 128, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(d / "rgb.png")
    Image.fromarray(img).save(d / "rgb.jpg", quality=95)
    Image.fromarray(img[:, :, 0]).save(d / "gray.png")
    Image.fromarray(img).convert("P").save(d / "palette.png")
    Image.fromarray(img).save(d / "rgb.bmp")
    paths = sorted(str(p) for p in d.iterdir()) + [str(FIXTURE / "db" / "000.jpg")]
    return paths + [str(d / "missing.jpg")]


def test_native_library_lands_in_the_port_build_dir(natives):
    lib = port_native.library_path()
    assert lib.exists() and lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert not str(lib).startswith(os.path.dirname(jax_native._IP_LIB_PATH) + os.sep)


@pytest.mark.parametrize("antialias", [False, True])
def test_native_decode_batch_is_bit_equal_to_jax(natives, images, antialias):
    for fn, args in (("decode_batch", ((70, 90), MEAN, STD)), ("decode_batch_u8", ((70, 90),))):
        got, gok = getattr(port_native, fn)(images, *args, antialias=antialias)
        want, wok = getattr(jax_native, fn)(images, *args, antialias=antialias)
        np.testing.assert_array_equal(gok, wok)
        assert gok.sum() >= 5 and not gok[-1]
        np.testing.assert_array_equal(got[gok], want[wok])


def test_native_decode_image_and_bytes_are_bit_equal_to_jax(natives, images):
    for p in images[:-1]:
        if p.endswith(".bmp"):
            continue
        np.testing.assert_array_equal(port_native.decode_image(p), jax_native.decode_image(p))
        data = pathlib.Path(p).read_bytes()
        for kw in (dict(size_hw=(64, 80)), dict(max_edge=64), dict(max_edge=2048),
                   dict(size_hw=(50, 60), antialias=True)):
            np.testing.assert_array_equal(port_native.decode_bytes_u8(data, **kw),
                                          jax_native.decode_bytes_u8(data, **kw))
    with pytest.raises(ValueError, match="failed to decode"):
        port_native.decode_image(images[-1])
    assert port_native.decode_bytes_u8(b"not an image", max_edge=64) is None
    with pytest.raises(ValueError, match="max_edge"):
        port_native.decode_bytes_u8(b"x")


@pytest.mark.parametrize("output", ["float32", "uint8"])
def test_batches_native_against_pil(natives, images, output):
    """batches() through the native pipe against the PIL path within
    tests/test_imagepipe.py's bounds: f32 2e-5, uint8 one step (the resize
    sums in another order and can cross a rounding midpoint); the bmp the
    native pipe does not read goes through PIL."""
    ds = VPRDataset(images[:-1], [], img_size=(70, 90))
    assert ds.decoder() == "native"
    nat = next(iter(ds.batches(8, output=output)))
    ds.use_native_loader = False
    assert ds.decoder() == "PIL"
    pil = next(iter(ds.batches(8, output=output)))
    np.testing.assert_array_equal(nat[1], pil[1])
    if output == "uint8":
        assert np.abs(nat[0].astype(int) - pil[0].astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(nat[0], pil[0], atol=2e-5)


def test_batches_pads_prefetches_and_drops_remainder(tmp_path):
    root = jax_synthetic.build_gardens(str(tmp_path), n_db=8, n_q=4)
    ds = port_registry.get_dataset("gardens", root, img_size=(32, 32))
    batches = list(ds.batches(3, which="db"))
    assert [b[0].shape for b in batches] == [(3, 32, 32, 3)] * 3
    assert batches[-1][1].tolist() == [6, 7, -1]
    inline = list(ds.batches(3, which="db", prefetch=0))
    for (a, i), (b, j) in zip(batches, inline):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(i, j)
    kept = list(ds.batches(3, which="queries", drop_remainder=True))
    assert [b[1].tolist() for b in kept] == [[8, 9, 10]]
