"""The share of the MoE's expert-buffer rows that an assignment fills: the
assignments kept over the buffer rows the expert products computed (E x
capacity a layer call), summed over the window's rounds from the round
step's ``moe_kept`` and ``moe_rows`` counts, in %."""


def read(ctx):
    rows = sum(m.get("moe_rows", 0) for m in ctx.window_rounds)
    kept = sum(m.get("moe_kept", 0) for m in ctx.window_rounds)
    return 100.0 * kept / rows if rows else None
