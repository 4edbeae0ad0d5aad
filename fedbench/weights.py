"""Each client's initial weights, made on the device from the seed.

Every client starts from its own draw, as the trainer's own initialisation
does.  A leaf is drawn from a generator seeded by (seed, client, leaf
path), in float32 on the device in one call, scaled, and rounded to the
dtype the model holds it in; the reference draws the same leaves the same
way and reads them as float32.  Scales: the two tables N(0, 0.02), each
matrix N(0, 1 / fan-in) with the fan-in its contracting dims, the router
N(0, 0.25 / hidden), norm scales 1, biases 0.
"""
from __future__ import annotations

import hashlib

import torch


def leaf_specs(sizes: dict) -> dict:
    """{leaf path: (shape, dtype, std or fill)} of one client's parameters,
    the stacked layer dim first."""
    D, V, L = sizes["hidden_size"], sizes["vocab_size"], \
        sizes["num_hidden_layers"]
    H, Kv, hd = sizes["num_attention_heads"], sizes["num_key_value_heads"], \
        sizes["head_dim"]
    F = sizes["intermediate_size"]
    bf16, f32 = torch.bfloat16, torch.float32
    spec = {
        "embed/in_table": ((V, D), bf16, 0.02),
        "embed/out_table": ((V, D), bf16, 0.02),
        "final_norm/scale": ((D,), f32, "ones"),
        "layers/ln1/scale": ((L, D), f32, "ones"),
        "layers/ln2/scale": ((L, D), f32, "ones"),
        "layers/attn/wq": ((L, D, H, hd), bf16, D ** -0.5),
        "layers/attn/wk": ((L, D, Kv, hd), bf16, D ** -0.5),
        "layers/attn/wv": ((L, D, Kv, hd), bf16, D ** -0.5),
        "layers/attn/wo": ((L, H, hd, D), bf16, (H * hd) ** -0.5),
    }
    if sizes.get("qkv_bias"):
        spec.update({"layers/attn/bq": ((L, H, hd), f32, "zeros"),
                     "layers/attn/bk": ((L, Kv, hd), f32, "zeros"),
                     "layers/attn/bv": ((L, Kv, hd), f32, "zeros")})
    E = sizes.get("num_local_experts")
    if E:
        spec.update({
            "layers/moe/router": ((L, D, E), f32, 0.5 * D ** -0.5),
            "layers/moe/w_gate": ((L, E, D, F), bf16, D ** -0.5),
            "layers/moe/w_up": ((L, E, D, F), bf16, D ** -0.5),
            "layers/moe/w_down": ((L, E, F, D), bf16, F ** -0.5)})
    else:
        spec.update({
            "layers/mlp/w_gate": ((L, D, F), bf16, D ** -0.5),
            "layers/mlp/w_up": ((L, D, F), bf16, D ** -0.5),
            "layers/mlp/w_down": ((L, F, D), bf16, F ** -0.5)})
    return spec


def _seed(seed: int, client: int, path: str) -> int:
    h = hashlib.blake2b(f"{seed}/{client}/{path}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def make_leaf(path: str, spec, seed: int, client: int, device) -> torch.Tensor:
    """One leaf of client ``client``'s initial weights, in its dtype."""
    shape, dtype, init = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, client, path))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(init).to(dtype)


def load_into(bank: dict, sizes: dict, seed: int, n_clients: int) -> None:
    """Writes every client's weights into the trainer's client-stacked
    parameter bank (``{path: (K, ...) tensor}``), leaf by leaf."""
    specs = leaf_specs(sizes)
    if set(bank) != set(specs):
        raise ValueError(f"the trainer's leaves {sorted(bank)} are not the "
                         f"configuration's {sorted(specs)}")
    for path, spec in specs.items():
        t = bank[path]
        if tuple(t.shape) != (n_clients,) + spec[0] or t.dtype != spec[1]:
            raise ValueError(f"{path}: the trainer holds {tuple(t.shape)} "
                             f"{t.dtype}, the configuration states "
                             f"{(n_clients,) + spec[0]} {spec[1]}")
        with torch.no_grad():
            for k in range(n_clients):
                t[k].copy_(make_leaf(path, spec, seed, k, t.device))
