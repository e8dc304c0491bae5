"""ctypes bindings of the native image pipe (``native/imagepipe.cpp``):
JPEG/PNG decode, tensor-mode bilinear resize and ImageNet normalization of
a whole batch on a thread pool — the DataLoader-worker equivalent.

A copy of the image-pipe half of ``anyloc_tpu/native.py`` (the port cannot
import that package without importing JAX). The source is the JAX
package's, unchanged; the port builds its own library with ``g++ ...
-ljpeg -lpng`` into ``build/native/`` at the repository root, named by a
hash of the source, the flags and the host's instruction set, and
published by tmp file + ``os.replace`` so that concurrent builders never
load a half-written file. Nothing builds at import time. Where g++ or the
libjpeg / libpng headers are missing, ``get_imagepipe()`` returns None and
callers decode with PIL, as the JAX package does.
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

_lock = threading.Lock()
_ip_lib: Optional[ctypes.CDLL] = None
build_error: Optional[str] = None  # why the library could not be built, once it could not


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


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(_host_isa())
    return BUILD_DIR / f"libimagepipe_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS],
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
