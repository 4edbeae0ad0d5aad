"""The round step's own ``aggregate_ms`` span (a CUDA event pair around
the aggregation), the mean over the window's rounds."""


def read(ctx):
    vals = [m["aggregate_ms"] for m in ctx.window_rounds
            if m.get("aggregate_ms") is not None]
    return sum(vals) / len(vals) if vals else None
