"""``fl_step.AdapterSpec`` (the LoRA adapter recipe) and
``fl_step.build_eval_step`` against the JAX package's.

* ``adapter_decls``: for every config, the same adapter names, shapes,
  logical axes, dtypes and init recipes as the reference's; only 2-D
  leaves are adapted, so a leaf stacked over layers gets none;
* ``filter()`` selects the same leaves as the reference's on every name
  of a base tree and its adapter bank;
* ``apply`` on parameters the reference materializes and adapters it
  draws (``lora_B`` from a numpy seed, so the fold is not the identity),
  loaded with ``from_reference``: f32 bases within 1e-6 relative of the
  reference's fold, bf16 bases within one bf16 ulp; unadapted leaves are
  the base's own tensors;
* ``build_eval_step`` gives the reference's ``eval_step`` cross-entropy
  and ``loss_fn``'s ``ce``, on the smoke configs of each family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core import fl_step as ref_fl_step
from repro.dist import sharding as ref_shd
from repro.models import model_api as ref_model_api
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, list_archs, smoke_config
from repro_torch.core import fl_step
from repro_torch.dist import sharding as shd
from repro_torch.models import model_api
from test_torch_common import (as_jax, as_torch, bf16_normal, bf16_ulp,
                               np_f32, tokens)

SPECS = [fl_step.AdapterSpec(),
         fl_step.AdapterSpec(rank=4, alpha=8.0, match=("embed/*",))]
REF_SPECS = [ref_fl_step.AdapterSpec(),
             ref_fl_step.AdapterSpec(rank=4, alpha=8.0, match=("embed/*",))]


def _decl_fields(d):
    return (tuple(d.shape), tuple(d.axes), d.init, float(d.scale),
            np.dtype(d.dtype).name if not isinstance(d.dtype, torch.dtype)
            else str(d.dtype).removeprefix("torch."))


@pytest.mark.parametrize("i", range(len(SPECS)))
@pytest.mark.parametrize("arch", list_archs())
def test_adapter_decls_match_reference(arch, i):
    """Names, shapes, axes, init recipes and dtypes of the adapter bank
    equal the reference's; every adapted leaf is 2-D, so no leaf stacked
    over ``layers`` (3-D or more) gets one."""
    base = model_api.param_decls(get_arch(arch))
    got = SPECS[i].adapter_decls(base)
    want = REF_SPECS[i].adapter_decls(
        ref_model_api.param_decls(ref_get_arch(arch)))
    assert sorted(got) == sorted(want) and got
    for name, d in got.items():
        assert _decl_fields(d) == _decl_fields(want[name]), name
    shapes = dict(zip(fl_step.leaf_path_names(base),
                      (d.shape for d in T.leaves(base))))
    for name in got:
        leaf = name.rsplit("/", 1)[0]
        assert len(shapes[leaf]) == 2, leaf
    stacked = [n for n, s in shapes.items() if len(s) > 2]
    assert stacked and not any(n.startswith(tuple(f"{s}/" for s in stacked))
                               for n in got)


@pytest.mark.parametrize("arch", list_archs())
def test_adapter_filter_matches_reference(arch):
    """``filter()`` keeps the leaves the reference's does among the base
    leaves' names and the bank's: every adapter tensor (and, as there, a
    base leaf of the same name, RWKV6's ddlerp ``lora_A``/``lora_B``)."""
    base = model_api.param_decls(get_arch(arch))
    names = fl_step.leaf_path_names(base) + sorted(
        SPECS[0].adapter_decls(base))
    got, want = SPECS[0].filter(), REF_SPECS[0].filter()
    assert (got.include, got.exclude) == (want.include, want.exclude)
    assert [got.matches(n) for n in names] == \
        [want.matches(n) for n in names]
    assert all(got.matches(n) for n in SPECS[0].adapter_decls(base))


def _ref_case(ref_cfg, spec, f32: bool, seed: int = 0):
    """The reference's parameters (f32 or their bf16 decl dtype) and its
    adapter bank, ``lora_B`` drawn from a numpy seed."""
    decls = ref_model_api.param_decls(ref_cfg)
    params = ref_shd.materialize(decls, jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                        params)
    bank = ref_shd.materialize(spec.adapter_decls(decls),
                               jax.random.PRNGKey(seed + 1))
    rng = np.random.default_rng(seed)
    bank = {k: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                if k.endswith("lora_B") else v) for k, v in bank.items()}
    return params, bank


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("i", range(len(SPECS)))
@pytest.mark.parametrize("arch", ["qwen2-7b", "internvl2-2b",
                                  "whisper-small"])
def test_adapter_apply_matches_reference(arch, i, f32):
    """The fold W + (alpha / rank) A @ B of the reference's parameters and
    adapters, loaded with ``from_reference``: f32 bases within 1e-6
    relative of each leaf's largest magnitude, bf16 bases within one bf16
    ulp (both round an f32 sum, whose last bits the two products may
    order differently); unadapted leaves are the base's own tensors."""
    ref_cfg = ref_smoke_config(ref_get_arch(arch))
    cfg = smoke_config(get_arch(arch))
    params, bank = _ref_case(ref_cfg, REF_SPECS[i], f32)
    want = np_f32(REF_SPECS[i].apply(params, bank))
    decls = model_api.param_decls(cfg)
    mine = shd.from_reference(np_f32(params), decls, "cpu",
                              dtype=torch.float32 if f32 else None)
    adapters = shd.from_reference(np_f32(bank),
                                  SPECS[i].adapter_decls(decls), "cpu")
    got = SPECS[i].apply(mine, adapters)
    adapted = {n.rsplit("/", 1)[0] for n in adapters}
    for (path, g), m, w in zip(T.leaves_with_path(got), T.leaves(mine),
                               T.leaves(want)):
        name = "/".join(path)
        assert g.dtype == m.dtype, name
        if name not in adapted:
            assert g is m, name
            continue
        g = g.float().numpy()
        if f32:
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), name
        else:
            assert (np.abs(g - w) <= bf16_ulp(w)).all(), name
        assert not np.array_equal(g, m.float().numpy()), name


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x22b", "rwkv6-7b",
                                  "hymba-1.5b", "whisper-small",
                                  "internvl2-2b"])
def test_build_eval_step_matches_reference(arch):
    """``eval_step(params, batch)`` is the reference's (its ``loss_fn``'s
    ``ce``) within 1e-6 relative at f32, and the port's ``loss_fn``'s
    ``ce`` exactly."""
    ref_cfg = ref_smoke_config(ref_get_arch(arch))
    cfg = smoke_config(get_arch(arch))
    params, _ = _ref_case(ref_cfg, REF_SPECS[0], True)
    batch = tokens(2, 24, cfg.vocab, seed=3)
    fe = cfg.frontend
    if fe is not None:
        key = "frames" if cfg.family == "encdec" else "patches"
        batch[key] = bf16_normal((2, fe.n_tokens, fe.feat_dim), 4)
    want = float(ref_fl_step.build_eval_step(ref_cfg)(params,
                                                      as_jax(batch)))
    mine = shd.from_reference(np_f32(params), model_api.param_decls(cfg),
                              "cpu", dtype=torch.float32)
    got = fl_step.build_eval_step(cfg)(mine, as_torch(batch))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    ce = model_api.loss_fn(cfg, mine, as_torch(batch))[1]["ce"]
    assert float(got) == float(ce)
