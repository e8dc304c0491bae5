"""Profiling / tracing utilities (counterpart of
``anyloc_tpu/utils/profiling.py``; the reference only wall-clocks ``main``
and counts FLOPs with torchscan): per-stage timers fenced on the card, a
``torch.profiler`` trace, and a FLOP count.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Wall-clock per-stage accumulation with device fencing: ``fence_on``
    a CUDA tensor waits for its device's queued work (a CPU tensor, or
    anything else, needs no fence)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @staticmethod
    def fence(x) -> None:
        import torch

        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)

    @contextlib.contextmanager
    def stage(self, name: str, fence_on=None):
        t0 = time.perf_counter()
        yield
        if fence_on is not None:
            self.fence(fence_on)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [
            f"{k:>24}: {v:8.3f}s ({100 * v / total:5.1f}%)"
            for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """``torch.profiler`` over the block (the CPU, and the card when there
    is one), its Chrome trace written to ``log_dir/trace.json`` (open it in
    chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def flops_of(fn, *args) -> Optional[float]:
    """FLOPs of ``fn(*args)`` from ``torch.utils.flop_counter`` (replaces
    torchscan, dvgl util.py:14-19), counted on the plain path whatever
    device the arguments are on: a kernel launched through ctypes is
    invisible to the counter, so ``fn`` runs on shape-only CPU copies of
    the tensor arguments (and of its parameters and buffers when it is a
    module), where each kernel wrapper takes its plain version. Returns
    None when ``fn`` cannot run so (e.g. a closure over card tensors)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FakeTensorMode():
            def fake(t):
                if isinstance(t, torch.Tensor):   # made inside the mode: no memory, no data
                    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cpu")
                return t

            fargs = [fake(a) for a in args]
            if isinstance(fn, torch.nn.Module):
                state = {**dict(fn.named_parameters()), **dict(fn.named_buffers())}
                fstate = {k: fake(v) for k, v in state.items()}

                def call(*a):
                    return torch.func.functional_call(fn, fstate, a)
            else:
                call = fn
            with FlopCounterMode(display=False) as counter:
                call(*fargs)
        return float(counter.get_total_flops())
    except Exception:
        return None
