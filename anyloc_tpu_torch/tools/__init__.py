"""The port's block-variant benchmarks (counterparts of the JAX package's
``tools/bench_fused_block.py``, ``tools/bench_attn_half_bf16.py`` and
``tools/bench_attn_proj.py``). Each has a ``run(...)`` that returns its
numbers and a ``__main__``; they run on a CUDA card and raise without one:

    python -m anyloc_tpu_torch.tools.bench_fused_block [N ...]
"""
