"""ctypes bindings of the native host libraries: the image pipe
(``native/imagepipe.cpp``: JPEG/PNG decode, tensor-mode bilinear resize
and ImageNet normalization of a whole batch on a thread pool, the
DataLoader-worker equivalent) and nnsearch (``native/nnsearch.cpp``:
threaded exact top-k, the FAISS ``IndexFlat`` stand-in, a host IVF and
Recall@K).

A copy of ``anyloc_tpu/native.py`` (the port cannot import that package
without importing JAX). The sources are the JAX package's, unchanged; the
port builds its own libraries with the JAX package's flags into
``build/native/`` at the repository root, each named by a hash of its
source, the flags and the host's instruction set, and published by tmp
file + ``os.replace`` so that concurrent builders never load a
half-written file. It never writes into ``native/`` and never loads the
library committed there. Nothing builds at import time. Where g++ or the
libjpeg / libpng headers are missing, ``get_imagepipe()`` returns None and
callers decode with PIL, as the JAX package does; where nnsearch cannot be
built, its functions raise (``nnsearch_build_error`` says why).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "native" / "imagepipe.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")
NN_SRC = ROOT / "native" / "nnsearch.cpp"
NN_FLAGS = ("-O3", "-march=native", "-ffast-math", "-pthread", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_ip_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None  # why the image pipe could not be built, once it could not
_nn_lib: Optional[ctypes.CDLL] = None
nnsearch_build_error: Optional[str] = None  # the same for nnsearch


def _host_isa() -> bytes:
    """The host's instruction-set flags: ``-march=native`` compiles for
    them, so a library built on another CPU is never loaded here."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def _library_path(src: Path, flags, libs, stem: str) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(tuple(flags) + tuple(libs)).encode())
    h.update(_host_isa())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the image pipe's library is built."""
    return _library_path(SRC, CXX_FLAGS, LIBS, "libimagepipe")


def nnsearch_library_path() -> Path:
    """Where the nnsearch library is built."""
    return _library_path(NN_SRC, NN_FLAGS, (), "libnnsearch")


def _build(src: Path = SRC, flags=CXX_FLAGS, libs=LIBS, out: Optional[Path] = None) -> Path:
    out = library_path() if out is None else out
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *flags, str(src), "-o", str(tmp), *libs],
                       check=True, capture_output=True)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees a torn file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def get_imagepipe() -> Optional[ctypes.CDLL]:
    """The native decode + resize + normalize library, built on first use;
    None where it cannot be built (no g++, no libjpeg / libpng headers)."""
    global _ip_lib, build_error
    with _lock:
        if _ip_lib is not None or build_error is not None:
            return _ip_lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except subprocess.CalledProcessError as e:
            build_error = (e.stderr or b"").decode(errors="replace").strip() or str(e)
            return None
        except OSError as e:   # no g++, no source, or a library that does not load
            build_error = str(e)
            return None
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, f32p, f32p, f32p, i64p, ctypes.c_int,
        ]
        lib.decode_batch.restype = i64
        lib.decode_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ]
        lib.decode_probe.restype = ctypes.c_int
        lib.decode_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), i64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, i64p, ctypes.c_int,
        ]
        lib.decode_batch_u8.restype = i64
        lib.decode_bytes_u8.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.decode_bytes_u8.restype = ctypes.c_int
        _ip_lib = lib
        return _ip_lib


def imagepipe_available() -> bool:
    return get_imagepipe() is not None


def _require() -> ctypes.CDLL:
    lib = get_imagepipe()
    if lib is None:
        raise RuntimeError("native imagepipe unavailable (no g++/libjpeg?)")
    return lib


def decode_batch(
    paths: Sequence[str],
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
    n_threads: int = 0,
    antialias: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEG/PNG files -> normalized channels-last f32 [N, H, W, 3]
    on a native thread pool (``n_threads`` 0: one per core). Returns
    (batch, ok_mask); failed files decode to zeros with ok False.
    antialias=False is tensor-mode bilinear (``transforms.load_image``);
    True is PIL's antialiased convention."""
    lib = _require()
    h, w = out_hw
    n = len(paths)
    out = np.empty((n, h, w, 3), np.float32)
    ok = np.zeros(n, np.int64)
    # fsencode, not str.encode: listings may hold surrogate-escaped names
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_batch(
        arr, n, h, w, int(antialias),
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32),
        out, ok, n_threads,
    )
    return out, ok.astype(bool)


def decode_batch_u8(
    paths: Sequence[str],
    out_hw: Tuple[int, int],
    n_threads: int = 0,
    antialias: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEG/PNG files -> resized uint8 RGB [N, H, W, 3], not
    normalized (1/4 the host-to-device bytes of ``decode_batch``; the
    extractor normalizes on the device). Same resize, rounded to 8 bits."""
    lib = _require()
    h, w = out_hw
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    ok = np.zeros(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.decode_batch_u8(arr, n, h, w, int(antialias), out, ok, n_threads)
    return out, ok.astype(bool)


def decode_image(path: str) -> np.ndarray:
    """Raw decode of one JPEG/PNG file to uint8 RGB [H, W, 3], no resize:
    ``PIL.Image.open().convert('RGB')``, bit-identical for JPEG (same
    libjpeg IDCT). ``decode_probe`` is called twice: dims, then pixels."""
    lib = _require()
    w, h = ctypes.c_int(), ctypes.c_int()
    p = os.fsencode(path)
    if not lib.decode_probe(p, ctypes.byref(w), ctypes.byref(h), None):
        raise ValueError(f"failed to decode {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if not lib.decode_probe(
        p, ctypes.byref(w), ctypes.byref(h), out.ctypes.data_as(ctypes.c_void_p)
    ):
        raise ValueError(f"failed to decode {path}")
    return out


def decode_bytes_u8(
    data: bytes,
    *,
    size_hw: Optional[Tuple[int, int]] = None,
    max_edge: int = 0,
    antialias: bool = False,
) -> Optional[np.ndarray]:
    """Decode one in-memory JPEG/PNG and resize to uint8 RGB [H, W, 3].
    ``size_hw`` forces an exact output; otherwise the longest edge is
    capped at ``max_edge`` with a truncating scale. None when the library
    is unavailable or the buffer does not decode: callers fall back to
    PIL."""
    lib = get_imagepipe()
    if lib is None:
        return None
    if size_hw is not None:
        fh, fw = int(size_hw[0]), int(size_hw[1])
        cap = max(fh, fw)
    else:
        fh = fw = 0
        if max_edge <= 0:
            raise ValueError("need size_hw or max_edge")
        cap = max_edge   # a scaled image is capped to it, an unscaled one was already within
    out = np.empty((cap, cap, 3), np.uint8)   # C writes only [got_h * got_w * 3]
    gh, gw = ctypes.c_int(), ctypes.c_int()
    if not lib.decode_bytes_u8(data, len(data), fh, fw, int(max_edge),
                               int(antialias), out, ctypes.byref(gh),
                               ctypes.byref(gw)):
        return None
    return out.reshape(-1)[: gh.value * gw.value * 3].reshape(
        gh.value, gw.value, 3).copy()


# ------------------------------------------------------- nnsearch


def get_lib() -> Optional[ctypes.CDLL]:
    """The nnsearch library, built on first use; None where it cannot be
    built (no g++)."""
    global _nn_lib, nnsearch_build_error
    with _lock:
        if _nn_lib is not None or nnsearch_build_error is not None:
            return _nn_lib
        try:
            lib = ctypes.CDLL(str(_build(NN_SRC, NN_FLAGS, (), nnsearch_library_path())))
        except subprocess.CalledProcessError as e:
            nnsearch_build_error = (e.stderr or b"").decode(errors="replace").strip() or str(e)
            return None
        except OSError as e:
            nnsearch_build_error = str(e)
            return None
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.nn_search_mt.argtypes = [f32p, i64, i64, f32p, i64, i64, ctypes.c_int,
                                     f32p, i64p, ctypes.c_int]
        lib.nn_search_mt.restype = None
        lib.recall_at_k.argtypes = [i64p, i64, i64, i64p, i64p, i64p, i64, i64, i64, i64p]
        lib.recall_at_k.restype = None
        lib.ivf_search_mt.argtypes = [f32p, i64, i64, f32p, i64, i64p, i64p, f32p, i64, i64,
                                      i64, ctypes.c_int, f32p, i64p, ctypes.c_int]
        lib.ivf_search_mt.restype = None
        _nn_lib = lib
        return _nn_lib


def available() -> bool:
    return get_lib() is not None


def _require_nn() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native nnsearch unavailable (no g++?): {nnsearch_build_error}")
    return lib


def nn_search(db: np.ndarray, qu: np.ndarray, k: int, method: str = "cosine",
              n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k on the host, with ``ops.retrieval.top_k_search``'s
    conventions (cosine: inner products descending; l2: squared distances
    ascending). ``n_threads`` 0: one per core; queries split across
    threads, results do not depend on the count."""
    lib = _require_nn()
    db = np.ascontiguousarray(db, np.float32)
    qu = np.ascontiguousarray(qu, np.float32)
    k = min(k, db.shape[0])
    scores = np.empty((qu.shape[0], k), np.float32)
    idx = np.empty((qu.shape[0], k), np.int64)
    lib.nn_search_mt(db, db.shape[0], db.shape[1], qu, qu.shape[0], k,
                     0 if method == "cosine" else 1, scores, idx, n_threads)
    return scores, idx


def ivf_build(db: np.ndarray, n_cells: Optional[int] = None, n_iters: int = 20, seed: int = 0,
              method: str = "cosine") -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Host IVF build: numpy Lloyd steps -> (cells [n_cells, d], CSR
    (indptr [n_cells + 1], rows [n_db])), the inverted file of FAISS
    ``IndexIVFFlat`` for the host search. The start is drawn with
    ``np.random.default_rng(seed)``, as the JAX package draws it."""
    db = np.ascontiguousarray(db, np.float32)
    n, d = db.shape
    if n_cells is None:
        n_cells = max(1, int(np.sqrt(n)))
    n_cells = min(n_cells, n)
    rng = np.random.default_rng(seed)
    pts = db
    if method == "cosine":
        pts = db / np.maximum(np.linalg.norm(db, axis=1, keepdims=True), 1e-12)
    cells = pts[rng.choice(n, n_cells, replace=False)].copy()

    def assign(c):
        if method == "cosine":
            cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
            return np.argmax(pts @ cn.T, axis=1)
        return np.argmin(-2.0 * (pts @ c.T) + np.sum(c ** 2, 1)[None], axis=1)

    for _ in range(n_iters):
        labels = assign(cells)
        counts = np.bincount(labels, minlength=n_cells).astype(np.float64)
        sums = np.zeros((n_cells, d), np.float64)
        np.add.at(sums, labels, pts)
        nz = counts > 0
        cells[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)
    # the final assignment with the final centroids, so that a row sits in
    # the cell the search-time probe ranks first
    labels = assign(cells)
    if method == "cosine":
        # unit-norm centroids: the search probes by raw q·c
        cells = (cells / np.maximum(np.linalg.norm(cells, axis=1, keepdims=True), 1e-12)
                 ).astype(np.float32)
    order = np.argsort(labels, kind="stable").astype(np.int64)
    indptr = np.zeros(n_cells + 1, np.int64)
    np.cumsum(np.bincount(labels, minlength=n_cells), out=indptr[1:])
    return cells, (indptr, order)


def ivf_search(db: np.ndarray, qu: np.ndarray, k: int, cells: np.ndarray,
               csr: Tuple[np.ndarray, np.ndarray], n_probe: int = 8, method: str = "cosine",
               n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host IVF probed search (threaded), ``nn_search``'s conventions;
    probing every cell equals exact search."""
    lib = _require_nn()
    db = np.ascontiguousarray(db, np.float32)
    qu = np.ascontiguousarray(qu, np.float32)
    cells = np.ascontiguousarray(cells, np.float32)
    indptr, rows = (np.ascontiguousarray(a, np.int64) for a in csr)
    k = min(k, db.shape[0])
    scores = np.empty((qu.shape[0], k), np.float32)
    idx = np.empty((qu.shape[0], k), np.int64)
    lib.ivf_search_mt(db, db.shape[0], db.shape[1], cells, cells.shape[0], indptr, rows, qu,
                      qu.shape[0], k, n_probe, 0 if method == "cosine" else 1, scores, idx,
                      n_threads)
    return scores, idx


def recall_at_k(retrieved: np.ndarray, gt_pos: Sequence[np.ndarray], top_k: Sequence[int],
                sub_sample_db: int = 1, sub_sample_qu: int = 1) -> dict:
    """Recall@K hit counts over CSR-packed ground truth, on the host."""
    lib = _require_nn()
    retrieved = np.ascontiguousarray(retrieved, np.int64)
    n_qu, max_k = retrieved.shape
    indptr = np.zeros(len(gt_pos) + 1, np.int64)
    for i, g in enumerate(gt_pos):
        indptr[i + 1] = indptr[i] + len(g)
    data = (np.concatenate([np.asarray(g, np.int64) for g in gt_pos])
            if indptr[-1] else np.zeros(0, np.int64))
    ks = np.asarray(sorted(top_k), np.int64)
    hits = np.zeros(len(ks), np.int64)
    lib.recall_at_k(retrieved, n_qu, max_k, indptr, data, ks, len(ks), sub_sample_db,
                    sub_sample_qu, hits)
    return {int(k): int(h) for k, h in zip(ks, hits)}
