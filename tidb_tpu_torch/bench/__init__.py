"""Benchmark harnesses (ref: cmd/benchdb workload CLI + util/benchdaily
JSON trend emitter)."""
