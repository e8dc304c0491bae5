"""Timing on the card, shared by the tools and ``chip_smoke.py``."""

from __future__ import annotations

import subprocess

import torch


def require_card(name: str) -> torch.device:
    """The CUDA card, or raise: a measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: needs a CUDA card (times are device times)")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them: every
    time is written beside them (a card below its power limit runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, reps: int = 3, warmup: int = 2) -> float:
    """Best of ``reps`` means over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def chain(layer_fn, x, layers: int):
    """A call that runs ``layers`` layers, each output feeding the next."""
    def go():
        h = x
        for _ in range(layers):
            h = layer_fn(h)
        return h
    return go


def as_linear_t(a, device, dtype=None) -> torch.Tensor:
    """A JAX-layout numpy weight [in, out] held in nn.Linear's [out, in]
    storage and passed as its .t() view, so the kernels' wrappers read it
    without a copy and no transpose is timed."""
    t = torch.from_numpy(a.T.copy()).to(device)
    return (t if dtype is None else t.to(dtype)).t()
