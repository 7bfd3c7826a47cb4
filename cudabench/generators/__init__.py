"""One module per data generator a configuration names:
``generate(seed, rows, config) -> {table: {column: array}}``."""
