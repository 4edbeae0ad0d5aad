"""A cell at a size the CPU tests can hold: the configuration's kinds of
layer, optimizer and schedule, at small widths and a short sequence."""
from fedbench import cells

SHAPES = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, vocab_size=256,
              remat=False)


def cell(name: str):
    c = cells.resolve(name)
    c.config = dict(c.config, **SHAPES)
    c.traffic = dict(c.traffic, seq_len=32, batch_per_client=2)
    return c


def run(name: str, seed: int, limits=None, seconds: float = 0.5):
    """A whole run of the cell at the small size on the CPU."""
    import time

    from fedbench import harness
    c = cell(name)
    if limits is not None:
        c.limits = limits
    return harness.run_cell(c, seed, seconds, False, "cpu",
                            time.perf_counter(), sizes=c.config)


def limits(name: str, seed: int) -> dict:
    """The cell's limits at the small size: the card's limit, or four
    times the sound run's reading where the small shapes read higher
    (their weights sit on coarser bf16 steps); exact counts stay 0."""
    sound = run(name, seed)["checks"]
    return {n: {"limit": c["limit"] if c["limit"] == 0 else
                max(c["limit"], 4 * c["value"])} for n, c in sound.items()}
