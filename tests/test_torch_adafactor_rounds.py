"""Federated rounds under Adafactor against the JAX package: one tree round
of mixtral-8x22b's smoke config (MoE) and of internlm2-20b's (dense), K = 4,
each held against the reference's no-mesh anchor (the cohort local step,
then ``fedavg_pytree(force="ref")``) in the bank and in the factored
``{"f": ...}`` state; then the trainer and the CLI on the CPU."""
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
from repro.kernels.fedavg.ops import fedavg_pytree as ref_fedavg_pytree
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core.fl_step import build_fl_round_step, init_opt_state
from repro_torch.core.topology import AggSchedule
from repro_torch.ft.failures import FailurePlan
from repro_torch.launch.train import SDFLMQTrainer
from repro_torch.models import moe
from repro_torch.optim.api import make_optimizer
from test_torch_common import (assert_trees_close, port_params, ref_params,
                               tokens)
from test_torch_train import _env

ARCHS = ["mixtral-8x22b", "internlm2-20b"]
K, E, TOTAL = 4, 2, 8
WEIGHTS = np.array([3.0, 1.0, 2.0, 4.0], np.float32)
TREE = AggSchedule("tree", K, (((0, 1), (2, 3)), ((0, 1, 2, 3),)),
                   ((1, 0, 1, 0),))


def _cfgs(arch):
    return ref_smoke_config(ref_get_arch(arch)), smoke_config(get_arch(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_adafactor_round_matches_reference_composition(arch):
    """Two local steps a client (lr(0) = 0: the second moves the weights)
    and one fedavg over the tree.  Both configs use Adafactor."""
    ref_cfg, cfg = _cfgs(arch)
    assert cfg.optimizer == ref_cfg.optimizer == "adafactor"
    rp = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *(
        ref_params(ref_cfg, seed=s) for s in range(3, 3 + K)))
    batch = tokens(1, 40, cfg.vocab, seed=11, lead=(K,))

    local = ref_cohort_step(ref_cfg, K, total_steps=TOTAL, local_steps=E)
    opt = ref_make_optimizer(ref_cfg, total_steps=TOTAL)
    rstate = {"params": rp, "opt": jax.vmap(opt.init)(rp),
              "step": jnp.zeros((), jnp.int32)}
    rstate, m = local(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    glob = ref_fedavg_pytree(rstate["params"], jnp.asarray(WEIGHTS),
                             force="ref")

    params = port_params(rp, cfg, n_clients=K)
    state = {"params": params,
             "opt": init_opt_state(make_optimizer(cfg, total_steps=TOTAL),
                                   params, K),
             "step": 0}
    step = build_fl_round_step(cfg, K, TREE, device="cpu", total_steps=TOTAL,
                               local_steps=E)
    state, got = step(state, batch, WEIGHTS)
    assert state["step"] == E
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=1e-5)
    for leaf in T.leaves(state["params"]):
        assert all(torch.equal(leaf[k], leaf[0]) for k in range(1, K))
    # f32 gradients summed in another order; Adafactor's step is lr * u
    # with |u| ~ 1, so atol 1e-5 is lr(1) / 30
    assert_trees_close(T.tree_map(lambda t: t[0], state["params"]), glob,
                       rtol=1e-4, atol=1e-5)
    # the factored second moments, client by client: row/column means of
    # squared gradients (f32 sums in another order)
    assert_trees_close(state["opt"], rstate["opt"], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("remat", [False, True])
def test_moe_trainer_on_cpu_reports_drops_and_aux(arch, remat):
    """Two rounds of the trainer at the smoke config with a failure: finite
    losses, identical slots, and the MoE layer's statistics counting each
    layer forward once, with remat too (its recompute stops before the
    count): the dropped assignments and the auxiliary loss, near its
    balanced value ``aux_coef``."""
    cfg = smoke_config(get_arch(arch)).replace(remat=remat)
    plan = FailurePlan(fail_at={1: ["c3"]})
    tr = SDFLMQTrainer(cfg, 4, 2, 2, 32, failure_plan=plan, device="cpu")
    assert set(tr.state["opt"]) == {"f"}
    moe.reset_stats()
    ms = tr.run()
    stats = moe.read_stats()
    assert [m["round"] for m in ms] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in ms)
    assert ms[1]["n_clients"] == 3
    # one call an MoE layer and client a round, drops summed
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    assert stats["calls"] == n_moe * 4 * 2
    assert 0 <= stats["dropped"] < stats["calls"] * 2 * 32 * cfg.moe.top_k
    assert 0.5 * cfg.moe.aux_coef < stats["aux_mean"] < 2 * cfg.moe.aux_coef
    for t in T.leaves(tr.state["params"]):
        assert all(torch.equal(t[k], t[0]) for k in range(4))


@pytest.mark.parametrize("arch", ARCHS + ["kimi-k2-1t-a32b"])
def test_train_cli_on_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--rounds", "2", "--seq", "32"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("round") == 2
