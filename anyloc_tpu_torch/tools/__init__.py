"""The port's kernel benchmarks, counterparts of the JAX package's tools:
the block variants (``tools/bench_fused_block.py``,
``tools/bench_attn_half_bf16.py``, ``tools/bench_attn_proj.py``) and the
micro-benchmarks of T1-T3 (``tools/bench_int8_matmul.py``,
``tools/bench_xlayer.py``); and ``bench_attention``, the port's own (K2
beside SDPA at each main-path sequence length). Each has a ``run(...)``
that returns its numbers and a ``__main__``; they run on a CUDA card and
raise without one:

    python -m anyloc_tpu_torch.tools.bench_fused_block [N ...]
"""
