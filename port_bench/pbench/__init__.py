"""The port's benchmark harness: what one run of one cell needs besides
the data files under ``port_bench/`` (cells, configurations, traffic mixes)
and the per-metric readers under ``port_bench/metrics/``."""
