"""End-to-end metrics: one ``read(ctx)`` a file, named as in
BENCHMARK.json; each reads the host clock's window of ``ctx``."""
