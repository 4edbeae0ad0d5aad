"""The port's RWKV6 and Hymba families against the JAX package on their
smoke configs: declarations, logits, loss and gradients (torch autograd
through the WKV Function vs jax.grad), one federated round against the
reference's no-mesh anchor, and the trainer's CLI."""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as ref_get_arch
from repro.configs.base import smoke_config as ref_smoke_config
from repro.core.fl_step import build_cohort_local_step as ref_cohort_step
from repro.dist import sharding as ref_shd
from repro.kernels.fedavg.ops import fedavg_pytree as ref_fedavg_pytree
from repro.models import model_api as ref_model_api
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import build_fl_round_step
from repro_torch.core.topology import AggSchedule
from repro_torch.models import model_api
from repro_torch.optim.api import make_optimizer
from test_torch_common import (assert_trees_close, port_params, ref_params,
                               tokens)
from test_torch_train import _env

ARCHS = ["rwkv6-7b", "hymba-1.5b"]
K, E, TOTAL = 4, 1, 4
WEIGHTS = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
TREE = AggSchedule("tree", K, (((0, 1), (2, 3)), ((0, 1, 2, 3),)),
                   ((1, 0, 1, 0),))


def _cfgs(arch, **kw):
    return (ref_smoke_config(ref_get_arch(arch)).replace(**kw),
            smoke_config(get_arch(arch)).replace(**kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_decls_match_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): d
           for path, d in jax.tree_util.tree_flatten_with_path(
               ref_model_api.param_decls(ref_cfg),
               is_leaf=ref_shd.is_decl)[0]}
    port = {"/".join(p): d
            for p, d in T.leaves_with_path(model_api.param_decls(cfg))}
    assert list(port) == list(ref)
    for name, d in port.items():
        r = ref[name]
        assert (d.shape, d.axes, d.init, d.scale) == \
            (r.shape, r.axes, r.init, r.scale), name
        assert str(d.dtype).split(".")[-1] == jnp.dtype(r.dtype).name, name


# seq 30: a ragged last WKV chunk (chunk 8); seq 96: hymba's attention
# above the smoke threshold of 64, so the flash path with window 32
@pytest.mark.parametrize("seq", [30, 96])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_reference_f32(arch, seq):
    ref_cfg, cfg = _cfgs(arch)
    rp = ref_params(ref_cfg, seed=0)
    batch = tokens(2, seq, cfg.vocab, seed=seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def fn(p):
        logits = ref_model_api.get_model(ref_cfg).forward(ref_cfg, p, jb)[0]
        return ref_model_api.cross_entropy(logits, jb["labels"]), logits
    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(fn, has_aux=True))(rp)

    params = port_params(rp, cfg)
    for t in T.leaves(params):
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model_api.get_model(cfg).forward(cfg, params, tb)[0]
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    loss, parts = model_api.loss_fn(cfg, params, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert float(parts["aux"]) == 0.0
    grads = T.tree_map(lambda t: t.grad, params)
    assert_trees_close(grads, want_grads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_bf16(arch):
    ref_cfg, cfg = _cfgs(arch)
    rp = ref_params(ref_cfg, seed=1, f32=False)
    batch = tokens(2, 96, cfg.vocab, seed=5)
    want = ref_model_api.loss_fn(
        ref_cfg, rp, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    params = port_params(rp, cfg, dtype=None)       # the decls' own dtypes
    got = model_api.loss_fn(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    ref_cfg, cfg = _cfgs(arch)
    rp = ref_params(ref_cfg, seed=2)
    batch = {k: torch.from_numpy(v)
             for k, v in tokens(1, 40, cfg.vocab).items()}
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        params = port_params(rp, c)
        leaves = [t.requires_grad_(True) for t in T.leaves(params)]
        model_api.loss_fn(c, params, batch)[0].backward()
        out.append([t.grad for t in leaves])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_matches_reference_composition(arch):
    """One tree round (local step per client, then fedavg per leaf) vs the
    reference's cohort local step + ``fedavg_pytree(force="ref")``."""
    ref_cfg, cfg = _cfgs(arch)
    # K independent clients, stacked (draws of the shapes compiled above)
    rp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *(
        ref_params(ref_cfg, seed=s) for s in range(3, 3 + K)))
    batch = tokens(1, 24, cfg.vocab, seed=11, lead=(K,))

    local = ref_cohort_step(ref_cfg, K, total_steps=TOTAL, local_steps=E)
    opt = ref_make_optimizer(ref_cfg, total_steps=TOTAL)
    rstate = {"params": rp, "opt": jax.vmap(opt.init)(rp),
              "step": jnp.zeros((), jnp.int32)}
    rstate, m = local(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    glob = ref_fedavg_pytree(rstate["params"], jnp.asarray(WEIGHTS),
                             force="ref")

    params = port_params(rp, cfg, n_clients=K)
    state = {"params": params,
             "opt": make_optimizer(cfg, total_steps=TOTAL).init(params),
             "step": 0}
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=E)
    state, got = step(state, batch, WEIGHTS)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-5)
    for leaf in T.leaves(state["params"]):
        assert all(torch.equal(leaf[k], leaf[0]) for k in range(1, K))
    # Adam moves a weight by O(lr) even where its gradient is at rounding
    # level, so atol is lr / 3 (as in test_torch_fl_step)
    assert_trees_close(T.tree_map(lambda t: t[0], state["params"]), glob,
                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--rounds", "2", "--seq", "32"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("round") == 2
