"""Per-layer metrics: one ``read(ctx)`` a file, named as in BENCHMARK.json.
A reader that finds nothing to read returns None, and the metric is left
out of the result."""
