"""The port's kernel benchmarks, counterparts of the JAX package's tools:
the block variants (``tools/bench_fused_block.py``,
``tools/bench_attn_half_bf16.py``, ``tools/bench_attn_proj.py``) and the
micro-benchmarks of T1-T3 (``tools/bench_int8_matmul.py``,
``tools/bench_xlayer.py``), and of the root ``bench_retrieval.py``
(``bench_retrieval``: queries/s, recall against exact and index bytes of
each retrieval engine); and the port's own: ``bench_attention`` (K2
beside SDPA at each main-path sequence length) and ``vlad_near_ties`` (how
often K1's hard labels flip on near ties, and what a flip costs). Each
has a ``run(...)`` that returns its numbers and a ``__main__``; they run
on a CUDA card and raise without one:

    python -m anyloc_tpu_torch.tools.bench_fused_block [N ...]
"""
