"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds, not minutes). The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and the flags, so an edit rebuilds. Nothing here runs at import time:
``load_library()`` builds on first use, and importing the package never
needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argument types of every C entry point (pointers and the stream as void*)
SIGNATURES = {
    "anyloc_flash_attention": [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _P],
    "anyloc_attn_qkv_proj": [_P] * 9 + [_I] * 6 + [_F, _P],
    "anyloc_attention_bwd": [_P] * 11 + [_I] * 8 + [ctypes.POINTER(_L), _F, _P],
    "anyloc_qkv_proj_bwd": [_P] * 10 + [_I] * 9 + [_P],
    "anyloc_vlad_aggregate": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 4 + [_P],
    "anyloc_vlad_resident_clusters": [_I],
    "anyloc_fused_mlp_int8": [_P] * 16 + [_I] * 8 + [_F, _P],
    "anyloc_attn_half_int8": [_P] * 17 + [_I] * 7 + [_F, _F, _P],
    "anyloc_fused_block_int8": [_P] * 30 + [_I] * 9 + [_F, _F, _P],
    "anyloc_attn_half_bf16": [_P] * 12 + [_I] * 5 + [_F, _F, _P],
    "anyloc_fused_mlp_bf16": [_P] * 11 + [_I] * 6 + [_F, _P],
    "anyloc_attention_proj": [_P] * 6 + [_I] * 6 + [_L] * 9 + [_F, _P],
    "anyloc_matmul": [_P] * 3 + [_I] * 5 + [_P],
    "anyloc_matmul_dequant": [_P] * 5 + [_I] * 4 + [_P],
    "anyloc_attn_half_variant": [_P] * 17 + [_I] * 8 + [_F, _F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last compile


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from anyloc_tpu_torch/csrc at first use")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libanyloc_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report of
    registers, shared memory and spills."""
    global build_seconds
    extra = ("-Xptxas", "-v") if verbose else ()  # a report, same binary
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{out.stem}.{src.stem}.{tag}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for cmd, _, proc in jobs:
        report = proc.communicate()[0]
        reports.append(report)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}:\n{report}")
    tmp = out.with_suffix(f".{tag}.so")
    try:
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel link failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    if verbose:
        print("".join(reports), flush=True)
    os.replace(tmp, out)  # atomic: a concurrent builder never sees a torn file
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's
    ``argtypes``/``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.anyloc_error_string.argtypes = [ctypes.c_int]
            lib.anyloc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = load_library().anyloc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
