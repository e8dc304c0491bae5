"""The work plan of K5's projection backward (``csrc/proj_bwd_plan.cuh``)
and its Python mirror (``ops/kernels/attn_proj.py``: ``proj_bwd_plan``,
``proj_bwd_units``, ``proj_bwd_workspace``).

The persistent kernel walks a static list of work units: d_o's 128 x 128
output tiles, d_W's (tile, row chunk) units and, with more than one chunk,
the reduction units that add each d_W tile's chunks, block b of the grid
taking units b, b + grid, ... Here the mirror's list covers every element of
d_o and of d_W exactly once (and each d_W tile's rows once more in reduction
units, which come after every chunk they wait for), each d_W tile's chunks
cover the rows 0..M-1 once and in order, and the header, compiled with g++
(it is plain C++), gives the same plan, the same units for every block and
the same scratch.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from anyloc_tpu_torch.ops.kernels.attn_proj import (
    PB_DO,
    PB_DW,
    PB_K,
    PB_RED,
    PB_TILE,
    proj_bwd_plan,
    proj_bwd_units,
    proj_bwd_workspace,
)

CSRC = Path(__file__).resolve().parents[1] / "anyloc_tpu_torch" / "csrc"

# (M, D, Nc): the dvgl vit step's [48 x 197, 768, 768]; one row; a ragged
# M; d_out a multiple of 8 but not of 128; D != d_out; DINOv2-G's
# [32 x 257, 1536, 1536] and ViT-H's [2 x 1370, 1280, 1280]
SHAPES = [(9456, 768, 768), (1, 768, 768), (130, 768, 768), (9456, 384, 1000),
          (130, 200, 136), (1, 64, 8), (2000, 1024, 1024), (8224, 1536, 1536),
          (2740, 1280, 1280)]
SMS = [132, 1]
WANTS = [(True, True, True), (True, False, False), (False, True, True), (False, False, True)]


def _cases():
    return [(m, d, nc, sms, w) for (m, d, nc) in SHAPES for sms in SMS for w in WANTS]


@pytest.mark.parametrize("m,d,nc,sms,wants", _cases(),
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_units_cover_each_output_once(m, d, nc, sms, wants):
    want_o, want_w, want_sums = wants
    plan = proj_bwd_plan(m, d, nc, sms, want_o, want_w, want_sums)
    blocks = proj_bwd_units(plan, m, nc)
    assert plan["grid"] == min(plan["units"], sms) and len(blocks) == plan["grid"]
    units = [u for blk in blocks for u in blk]
    assert len(units) == plan["units"]
    # block b takes units b, b + grid, ...: the counts differ by at most one
    sizes = [len(blk) for blk in blocks]
    assert not sizes or max(sizes) - min(sizes) <= 1
    do = np.zeros((m, d), dtype=np.int32)
    red = np.zeros((d, nc), dtype=np.int32)
    dw_rows = {}   # d_W tile -> [(chunk, k0, k1)]
    order = [u for b in range(len(blocks)) for u in range(b, plan["units"], plan["grid"])]
    last_dw = max([i for i, (k, *_) in zip(order, units) if k == PB_DW], default=-1)
    for idx, (kind, ti, tj, chunk, k0, k1) in zip(order, units):
        if kind == PB_DW:
            dw_rows.setdefault((ti, tj), []).append((chunk, k0, k1))
        elif kind == PB_DO:
            assert (k0, k1) == (0, nc)
            do[ti * PB_TILE:(ti + 1) * PB_TILE, tj * PB_TILE:(tj + 1) * PB_TILE] += 1
        else:
            assert kind == PB_RED and idx > last_dw     # after every chunk it waits for
            red[ti * PB_TILE + k0:ti * PB_TILE + k1, tj * PB_TILE:(tj + 1) * PB_TILE] += 1
    if want_o:
        assert (do == 1).all()
    else:
        assert not do.any()
    if not want_w:
        assert not dw_rows and plan["chunks"] == 0 and not red.any()
        return
    cover = np.zeros((d, nc), dtype=np.int32)
    for (ti, tj), chunks in dw_rows.items():
        cover[ti * PB_TILE:(ti + 1) * PB_TILE, tj * PB_TILE:(tj + 1) * PB_TILE] += 1
        chunks.sort()
        assert [c for c, _, _ in chunks] == list(range(plan["chunks"]))
        assert chunks[0][1] == 0 and chunks[-1][2] == m   # rows 0..M-1, in order, once
        for (_, _, end), (_, start, _) in zip(chunks, chunks[1:]):
            assert end == start
        for _, k0, k1 in chunks:
            assert k1 > k0 and k0 % PB_K == 0      # whole stages; only M cuts the last
    assert (cover == 1).all()
    assert (red == (1 if plan["chunks"] > 1 else 0)).all()
    # a chunk has about as many stages as a d_o unit (at least 8)
    target = max(-(-nc // PB_K), 8)
    assert plan["chunk_rows"] // PB_K <= target


def test_the_vit_step_plan_by_hand():
    """qkv [48, 197, 2304]: M 9456 = 296 stages of 32 rows; d_o has 74 x 6
    tiles of 24 stages, d_W 6 x 6 tiles in 13 chunks of 23 stages (736 rows;
    the last 624), added up by 4 reduction units a tile; 1056 units on 132
    blocks, 8 each; the partials take 13 x 768² x 4 bytes; the column sums 24
    blocks of 32 columns x 22 row splits."""
    plan = proj_bwd_plan(9456, 768, 768, 132)
    assert (plan["m_tiles"], plan["d_tiles"], plan["c_tiles"]) == (74, 6, 6)
    assert (plan["chunks"], plan["chunk_rows"]) == (13, 736)
    assert (plan["n_do"], plan["n_dw"], plan["n_red"]) == (444, 468, 144)
    assert (plan["units"], plan["grid"]) == (1056, 132)
    assert (plan["col_splits"], plan["col_rows"]) == (22, 430)
    ws = proj_bwd_workspace(plan, 768, 768)
    assert ws["part"] == 256 and ws["col"] - ws["part"] == 13 * 768 * 768 * 4
    assert ws["bytes"] == ws["col"] + 2 * 22 * 768 * 4
    assert ws["bytes"] == 30_806_272


_SHIM = r"""
#include "proj_bwd_plan.cuh"
using namespace anyloc;
extern "C" void plan(int M, int D, int Nc, int sms, int wo, int ww, int ws, long long* out) {
  const ProjBwdPlan p = proj_bwd_plan(M, D, Nc, sms, wo, ww, ws);
  const ProjBwdWorkspace w = proj_bwd_workspace(p, D, Nc);
  const long long v[] = {p.m_tiles, p.d_tiles, p.c_tiles, p.chunks, p.chunk_rows, p.n_dw,
                         p.n_do, p.n_red, p.units, p.grid, p.col_splits, p.col_rows, w.counters,
                         w.part, w.col, w.bytes};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
}
extern "C" int units(int M, int D, int Nc, int sms, int wo, int ww, int ws, int* out) {
  const ProjBwdPlan p = proj_bwd_plan(M, D, Nc, sms, wo, ww, ws);
  int n = 0;
  for (int b = 0; b < p.grid; ++b)
    for (int i = 0; i < proj_bwd_block_units(p, b); ++i) {
      const ProjBwdUnit u = proj_bwd_unit(p, M, Nc, b + i * p.grid);
      const int v[] = {b, u.kind, u.ti, u.tj, u.chunk, u.k0, u.k1};
      for (int j = 0; j < 7; ++j) out[7 * n + j] = v[j];
      ++n;
    }
  return n;
}
"""

PLAN_KEYS = ("m_tiles", "d_tiles", "c_tiles", "chunks", "chunk_rows", "n_dw", "n_do", "n_red",
             "units", "grid", "col_splits", "col_rows")


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    assert cxx is not None, "g++ builds the plan header (plain C++) for this check"
    tmp = tmp_path_factory.mktemp("proj_bwd_plan")
    (tmp / "shim.cpp").write_text(_SHIM)
    lib = tmp / "libplan.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(lib),
                    str(tmp / "shim.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("m,d,nc,sms,wants", _cases(),
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_the_cuda_source_plan_matches_the_mirror(plan_lib, m, d, nc, sms, wants):
    args = (m, d, nc, sms, *map(int, wants))
    out = (ctypes.c_longlong * 16)()
    plan_lib.plan(*args, out)
    plan = proj_bwd_plan(m, d, nc, sms, *wants)
    ws = proj_bwd_workspace(plan, d, nc)
    assert list(out) == [plan[k] for k in PLAN_KEYS] + [ws[k] for k in
                                                          ("counters", "part", "col", "bytes")]
    buf = (ctypes.c_int * (7 * max(plan["units"], 1)))()
    n = plan_lib.units(*args, buf)
    got = np.frombuffer(buf, dtype=np.int32)[:7 * n].reshape(n, 7).tolist()
    want = [[b, *u] for b, blk in enumerate(proj_bwd_units(plan, m, nc)) for u in blk]
    assert got == want
