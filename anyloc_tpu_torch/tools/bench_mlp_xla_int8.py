"""K3 (the fused int8 MLP half) beside an MLP half built from library calls
(port of tools/bench_mlp_xla_int8.py, whose second route is XLA's).

    python -m anyloc_tpu_torch.tools.bench_mlp_xla_int8 [N_tokens ...]

The library route is the JAX tool's XLA route in PyTorch calls: LayerNorm,
a per-token int8 quantize, ``torch._int_mm`` for w12, dequantize +
SwiGLU + requantize (per row), ``torch._int_mm`` for w3, then LayerScale
and the residual; a composition of library calls, not one call. K3
requantizes per (row, 512-column chunk) of the hidden layer, where this
route takes whole rows (F1), so the outputs differ by rounding: the tool
prints their cosine. DINOv2-G widths (D 1536, hidden 4096), batch 32,
random int8 weights with per-column scales from a numpy seed, bfloat16
activations; times are CUDA-event means over 100 calls (the JAX tool's
count; ``run(iters=)``), best of 3,
with each call's rate in TOPS (int8 operations of both products). Every
line names the card and its power limit. It needs a card and raises
without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

D, HID, B = 1536, 4096, 32
NS = (257, 485)


def _quantize_rows(x: torch.Tensor):
    s = torch.clamp_min(x.abs().amax(-1, keepdim=True), 1e-6) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def library_mlp_int8(x, w12_q, w12_s, w3_q, w3_s, lns, lnb, gamma) -> torch.Tensor:
    """The JAX tool's ``xla_mlp_int8`` in PyTorch library calls. x [B, N,
    D]; w12_q int8 [D, 2·HID] and w3_q [HID, D] in the JAX layout (a
    Linear's ``weight.t()`` view), per-column f32 scales; LN scale / bias
    and LayerScale f32. Returns [B, N, D] in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + 1e-6) * lns + lnb
    xq, s = _quantize_rows(xn)
    hid = w3_q.shape[0]
    h = torch._int_mm(xq.reshape(-1, xq.shape[-1]), w12_q).reshape(*xq.shape[:-1], -1)
    hf = h.float() * s * w12_s
    a = F.silu(hf[..., :hid]) * hf[..., hid:]
    aq, s2 = _quantize_rows(a)
    o = torch._int_mm(aq.reshape(-1, hid), w3_q).reshape(*aq.shape[:-1], -1)
    of = o.float() * s2 * w3_s
    return (x.float() + gamma * of).to(x.dtype)


def weights(seed: int = 0, d: int = D, hid: int = HID) -> dict:
    """The JAX tool's weights (numpy seed, in its draw order): int8 w12 and
    w3 with per-column scales, LN 1 / 0, LayerScale 0.5, as numpy."""
    rng = np.random.default_rng(seed)

    def qw(shape):
        w = rng.standard_normal(shape).astype(np.float32) * 0.02
        s = np.abs(w).max(axis=0) / 127.0
        return np.round(w / s).clip(-127, 127).astype(np.int8), s.astype(np.float32)

    w12_q, w12_s = qw((d, 2 * hid))
    w3_q, w3_s = qw((hid, d))
    return dict(w12_q=w12_q, w12_s=w12_s, w3_q=w3_q, w3_s=w3_s,
                lns=np.ones(d, np.float32), lnb=np.zeros(d, np.float32),
                gamma=np.full(d, 0.5, np.float32), rng=rng)


def run(ns=NS, iters: int = 100, seed: int = 0) -> dict:
    """{"card", "shapes": {N: {"library_ms", "k3_ms", "library_tops", "k3_tops",
    "cosine"}}}."""
    from anyloc_tpu_torch.ops.kernels import fused_mlp_int8
    from anyloc_tpu_torch.tools._timing import as_linear_t, card_line, require_card, time_ms

    dev = require_card("bench_mlp_xla_int8")
    w = weights(seed)
    rng = w.pop("rng")
    w12_q, w3_q = (as_linear_t(w[k], dev) for k in ("w12_q", "w3_q"))
    w12_s, w3_s, lns, lnb, gamma = (torch.from_numpy(w[k]).to(dev)
                                    for k in ("w12_s", "w3_s", "lns", "lnb", "gamma"))
    out = {"card": card_line(), "shapes": {}}
    for n in ns:
        x = torch.from_numpy(rng.standard_normal((B, n, D)).astype(np.float32)).to(
            dev, torch.bfloat16)
        ops = 2 * B * n * (D * 2 * HID + HID * D)

        def lib():
            return library_mlp_int8(x, w12_q, w12_s, w3_q, w3_s, lns, lnb, gamma)

        def k3():
            return fused_mlp_int8(x, w12_q, w12_s, None, w3_q, w3_s, None,
                                  mlp_type="swiglu_fused", ln_params=(lns, lnb),
                                  layerscale=gamma, residual=True)

        a, b = lib().float().flatten(), k3().float().flatten()
        cos = float((a @ b) / (a.norm() * b.norm()))
        t_lib, t_k3 = time_ms(lib, iters=iters), time_ms(k3, iters=iters)
        out["shapes"][n] = dict(library_ms=t_lib, k3_ms=t_k3, library_tops=ops / t_lib / 1e9,
                                k3_tops=ops / t_k3 / 1e9, cosine=cos)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_tokens", nargs="*", type=int, default=list(NS))
    a = p.parse_args(argv)
    res = run(a.n_tokens)
    for n, r in res["shapes"].items():
        print(f"[{res['card']}] N={n}: library int8 {r['library_ms']:6.3f} ms "
              f"({r['library_tops']:5.1f} TOPS) | K3 fused {r['k3_ms']:6.3f} ms "
              f"({r['k3_tops']:5.1f} TOPS); cosine {r['cosine']:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
