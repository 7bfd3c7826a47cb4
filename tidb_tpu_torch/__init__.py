"""tidb_tpu_torch — the PyTorch/CUDA port of tidb_tpu's device read engine.

The port runs one region's pushed-down coprocessor DAG (scan → selection →
aggregation / TopN) on an NVIDIA GPU and returns the same ``Chunk`` the JAX
engine (``tidb_tpu.copr.tpu_engine``) returns. Its hand-written kernels live
under ``csrc/`` and are built with ``nvcc`` at first use
(``tidb_tpu_torch.native``).

Entry point: :func:`tidb_tpu_torch.copr.gpu_engine.execute_dag`. Every entry
point takes an explicit ``device`` (default ``"cuda"``); a default call on a
machine with no card raises instead of running on the CPU.

This package imports torch and numpy only — never jax, and nothing of the
``tidb_tpu`` package; it keeps its own copies of the host-side modules it
needs (types, chunk, expression, dagpb, binder).
"""
