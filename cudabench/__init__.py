"""cudabench: the benchmark of tidb_tpu_torch (see ``harness.py`` and
``README.md``). Importing it loads nothing of the program."""
