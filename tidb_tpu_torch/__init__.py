"""tidb_tpu_torch — the PyTorch/CUDA port of tidb_tpu.

An embedded SQL database whose pushed-down coprocessor fragments (scan →
selection → aggregation / TopN / LIMIT) run on an NVIDIA GPU. The SQL
front, the MVCC store and the host engine are copies of the reference's
host-side modules (``copies.py``); the ``gpu`` engine
(``copr/gpu_engine.py``) and its hand-written kernels (``csrc/``, built
with ``nvcc`` at first use by ``native/cuda.py``) are the port's own.

Quick start::

    import tidb_tpu_torch
    db = tidb_tpu_torch.open()      # device="cuda"; pass device="cpu" to
                                    # run the kernels' plain versions
    db.execute("CREATE TABLE t (a BIGINT, b DOUBLE)")
    db.execute("INSERT INTO t VALUES (1, 2.5), (2, 3.5)")
    rows = db.query("SELECT a, SUM(b) FROM t GROUP BY a")

Cop tasks go to the ``gpu`` engine when the session's
``tidb_isolation_read_engines`` (default ``"gpu,host"``) allows it and
every pushed expression is device-legal; the rest run on ``host``. With no
card a default handle raises on its first device task and never runs on
the CPU.

This package imports torch and numpy only — never jax, and nothing of the
``tidb_tpu`` package.
"""

__version__ = "0.1.0"

__all__ = ["open", "__version__"]


def open(region_split_keys: int = 500_000, remote=None, device="cuda"):  # noqa: A001  (db handle factory)
    from tidb_tpu_torch.session.session import open_db

    return open_db(region_split_keys=region_split_keys, remote=remote, device=device)
