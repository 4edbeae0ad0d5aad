"""The port's dry run (``repro_torch.launch.{dryrun,op_analysis,roofline}``)
against the reference's dry-run tooling, on the CPU with no spawned rank.

The reference's own lowering is red under jax 0.9 (ROADMAP R1), so the
anchors are the reference calls that run: ``param_counts``, ``cell_list``
and ``shape_applicable``'s reasons, the spec functions (``state_specs``,
``specs_for`` under ``rules_for(mode)``) read through a stand-in with the
production mesh's ``shape`` and ``axis_names``, the ring rule and the dot
FLOPs of ``hlo_analysis.analyze``, and ``roofline.Roofline`` with the
H100's constants swapped in.  Each kernel's ``cost()`` gives the bound the
chip script prints (PERF.md's kernel table), and ``lower_cell`` traces a
smoke config's train, prefill and decode cells on a (2, 2) mesh."""
from __future__ import annotations

import dataclasses
import math
import os
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_arch as ref_get_arch
from repro.core import fl_step as ref_fl_step
from repro.dist import sharding as ref_shd
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import roofline as ref_roofline
from repro.models import model_api as ref_model_api
from repro.optim.api import make_optimizer as ref_make_optimizer
from repro_torch import tree as T
from repro_torch.configs.base import (SHAPES, ShapeConfig, get_arch,
                                      list_archs, smoke_config)
from repro_torch.kernels.fedavg import ops as fedavg_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.quant8 import ops as quant8_ops
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.launch.op_analysis import OpCost, OpCounter
from repro_torch.launch.roofline import Roofline


def _ref_dryrun():
    """The reference's ``launch/dryrun.py``, imported with this process's
    ``XLA_FLAGS`` kept: the module sets 512 host devices at import, for a
    process that runs nothing else."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _ref_mesh(shape: dict):
    """What the reference's spec functions read of a mesh."""
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _block_shape(shape, spec, sizes) -> tuple:
    """A rank's block of a leaf of ``shape`` under a PartitionSpec."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _ref_blocks(tree, specs, sizes):
    """Leaf path -> (block shape, itemsize) of a reference tree of
    ShapeDtypeStructs (or decls) under ``specs``."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=ref_shd.is_decl)[0]
    flat_specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(flat, flat_specs):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = (_block_shape(leaf.shape, spec, sizes),
                     np.dtype(leaf.dtype).itemsize)
    return out


def _port_blocks(tree):
    return {"/".join(p): (tuple(t.shape), t.element_size())
            for p, t in T.leaves_with_path(tree) if torch.is_tensor(t)}


def _bytes(blocks) -> int:
    return sum(math.prod(s) * n for s, n in blocks.values())


@pytest.fixture
def fake_mesh():
    """A production mesh's rank 0 on the meta device; its fake process
    group is destroyed after the test."""
    made = []

    def make(shape):
        made.append(dryrun.fake_mesh(shape))
        return made[-1]
    yield make
    if made and dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# parameters and cells
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_reference(arch):
    ref = _ref_dryrun()
    assert dryrun.param_counts(get_arch(arch)) == \
        ref.param_counts(ref_get_arch(arch))


def test_cell_list_and_skips_equal_reference():
    ref = _ref_dryrun()
    assert dryrun.cell_list() == ref.cell_list()
    skipped = 0
    for arch, shape in dryrun.cell_list():
        if shape != "long_500k" or get_arch(arch).sub_quadratic:
            continue
        for mp in (False, True):
            got = dryrun.lower_cell(arch, shape, mp)
            assert got == ref.lower_cell(arch, shape, mp)
            assert got["status"] == "skipped" and "sub-quadratic" in \
                got["reason"]
            skipped += 1
    assert skipped == 12          # six full-attention archs x two meshes
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# what a rank holds on the production meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list_archs())
def test_train_state_bytes_a_rank_equal_reference_specs(arch, multi_pod,
                                                        fake_mesh):
    """The rank's parameters and optimizer state in a ``train_4k`` cell,
    leaf by leaf, against the reference's ``abstract_state`` shapes under
    its ``state_specs``."""
    sizes = mesh_lib.production_shape(multi_pod)
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    specs = dryrun.input_specs(cfg, SHAPES["train_4k"], fake_mesh(sizes))
    got = _port_blocks({k: specs["state"][k] for k in ("params", "opt")})

    rmesh = _ref_mesh(sizes)
    n = ref_fl_step.n_clients_for(ref_cfg, rmesh)
    p_abs = ref_shd.abstract(ref_fl_step.fl_param_decls(ref_cfg, n))
    opt = ref_make_optimizer(ref_cfg)
    o_abs = jax.eval_shape(jax.vmap(opt.init) if n > 1 else opt.init, p_abs)
    ref_specs = ref_fl_step.state_specs(ref_cfg, rmesh, opt.name)
    want = _ref_blocks({"params": p_abs, "opt": o_abs},
                       {"params": ref_specs["params"],
                        "opt": ref_specs["opt"]}, sizes)
    assert got == want
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", list_archs())
def test_decode_params_and_cache_a_rank_equal_reference_specs(
        arch, multi_pod, fake_mesh):
    """A ``decode_32k`` cell's parameter blocks and cache block against the
    reference's ``specs_for`` under ``rules_for(mode)``; Hymba's ``conv``
    state stays whole where its heads do (ROADMAP §3's departure), where
    the reference splits its Din dim."""
    sizes = mesh_lib.production_shape(multi_pod)
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    shape = SHAPES["decode_32k"]
    specs = dryrun.input_specs(cfg, shape, fake_mesh(sizes))
    rmesh = _ref_mesh(sizes)
    rules = ref_shd.rules_for(ref_cfg.fl.mode)
    decls = ref_model_api.param_decls(ref_cfg)
    assert _port_blocks(specs["params"]) == _ref_blocks(
        decls, ref_shd.specs_for(decls, rules, rmesh), sizes)

    clen = ref_model_api.cache_len_for(ref_cfg, shape.seq_len)
    cdecls = ref_model_api.get_model(ref_cfg).cache_decl(
        ref_cfg, shape.global_batch, max(clen, 1))
    cspecs = ref_shd.specs_for(cdecls, rules, rmesh)
    want = _ref_blocks(cdecls, cspecs, sizes)
    if cfg.family == "hybrid":
        conv = cdecls["conv"]
        assert "model" in cspecs["conv"]    # the reference splits Din
        kept = [None if ax == "heads" else m
                for ax, m in zip(conv.axes, cspecs["conv"])]
        want["conv"] = (_block_shape(conv.shape, kept, sizes),
                        want["conv"][1])
    got = _port_blocks(specs["cache"])
    assert got == want
    assert _bytes(got) == _bytes(want)


# --------------------------------------------------------------------------
# the op counter against hlo_analysis
# --------------------------------------------------------------------------

def _hlo(kind: str, g: int, n: int) -> str:
    """A one-collective HLO module over f32[n] (all-gather: its input
    f32[n / g]), replica groups of ``g`` consecutive ranks of 32."""
    groups = ",".join("{" + ",".join(str(i) for i in range(s, s + g)) + "}"
                      for s in range(0, 32, g))
    m = n // g if kind in ("all-gather",) else n
    out = n // g if kind == "reduce-scatter" else n
    return f"""
ENTRY %main (p: f32[{m}]) -> f32[{out}] {{
  %p = f32[{m}]{{0}} parameter(0)
  ROOT %c = f32[{out}]{{0}} {kind}(%p), channel_id=1, replica_groups={{{groups}}}, dimensions={{0}}, to_apply=%add
}}
"""


@pytest.mark.parametrize("g", [4, 16])
def test_op_counter_wire_bytes_equal_hlo_analysis(g):
    """An all-reduce, an all-gather and a reduce-scatter of meta tensors in
    a fake group of ``g`` ranks: the wire bytes ``hlo_analysis.analyze``
    gives the same collectives, and a group of 16 (two nodes of 8) counted
    across nodes."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    n = 4096
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=32)
    try:
        group = dist.new_group(list(range(g)))
        x = torch.empty((n,), device="meta")
        with OpCounter() as oc:
            dist.all_reduce(x, group=group)
            dist.all_gather_into_tensor(x, x[:n // g], group=group)
            dist.reduce_scatter_tensor(x[:n // g], x, group=group)
    finally:
        dist.destroy_process_group()
    c = oc.cost
    for kind in ("all-reduce", "all-gather", "reduce-scatter"):
        want = ref_hlo.analyze(_hlo(kind, g, n), 32)
        assert c.coll_per_op[kind] == pytest.approx(want.coll_bytes,
                                                    rel=1e-12)
        assert c.coll_counts[kind] == want.coll_counts[kind] == 1
        assert c.coll_by_group[f"{kind}/{g}"]["count"] == 1
    assert c.coll_cross_node_bytes == (c.coll_bytes if g > 8 else 0.0)


def test_op_counter_flops_equal_hlo_analysis_scan():
    """Six (32, 64) @ (64, 64) products: the FLOPs ``analyze`` recovers
    from the reference's scan of them (``tests/test_hlo_and_serve.py``)."""
    import jax.numpy as jnp

    def body(x, w):
        return jnp.tanh(jnp.dot(x, w)), None

    comp = jax.jit(lambda x, ws: jax.lax.scan(body, x, ws)[0]).lower(
        jax.ShapeDtypeStruct((32, 64), jnp.float32),
        jax.ShapeDtypeStruct((6, 64, 64), jnp.float32)).compile()
    want = ref_hlo.analyze(comp.as_text(), 1).flops
    x = torch.empty((32, 64), device="meta")
    ws = torch.empty((6, 64, 64), device="meta")
    with OpCounter() as oc:
        for w in ws:
            x = torch.tanh(x @ w)
    assert oc.cost.flops == want == 6 * 2 * 32 * 64 * 64
    assert oc.cost.op_counts["mm"] == 6


def test_op_counter_counts_f32_output_products():
    """The ``.dtype`` overloads of mm and bmm (``_mm_f32``'s f32-output
    GEMMs on the card, and so on meta) count as the plain products."""
    m = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    a, b = m(4, 8, 16), m(4, 16, 32)
    with OpCounter() as oc:
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.mm(a[0], b[0], out_dtype=torch.float32)
    assert oc.cost.flops == 2 * 4 * 8 * 16 * 32 + 2 * 8 * 16 * 32
    assert oc.cost.op_counts == {"bmm": 1, "mm": 1, "select": 2}


def test_roofline_equals_reference_with_h100_constants(monkeypatch):
    cost = OpCost(flops=3.1e15, hbm_bytes=7.7e13, coll_bytes=2.5e11,
                  coll_cross_node_bytes=9e10)
    got = Roofline(cost, 256, 1.9e17)
    for name, val in (("PEAK_FLOPS_BF16", mesh_lib.PEAK_FLOPS_BF16),
                      ("HBM_BW", mesh_lib.HBM_BW),
                      ("ICI_BW", mesh_lib.NVLINK_BW),
                      ("DCN_BW", mesh_lib.NET_BW)):
        monkeypatch.setattr(ref_roofline, name, val)
    ref_cost = ref_hlo.HLOCost(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                               coll_bytes=cost.coll_bytes,
                               coll_cross_pod_bytes=9e10)
    want = ref_roofline.Roofline(ref_cost, 256, 1.9e17)
    for prop in ("compute_s", "memory_s", "collective_s", "dominant",
                 "useful_flops_ratio", "bound_s", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    d = got.to_dict()
    for key in ("flops_per_dev", "collective_bytes", "collective_counts",
                "compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_total", "useful_flops_ratio",
                "roofline_fraction"):     # what report.py reads
        assert key in d
    assert mesh_lib.production_shape(False) == {"data": 16, "model": 16}
    assert mesh_lib.production_shape(True) == {"pod": 2, "data": 16,
                                               "model": 16}


# --------------------------------------------------------------------------
# the kernels' costs
# --------------------------------------------------------------------------

def _bound_ms(cost) -> float:
    return max(cost[0] / mesh_lib.PEAK_FLOPS_BF16,
               cost[1] / mesh_lib.HBM_BW) * 1e3


BF16 = torch.bfloat16
KERNEL_BOUNDS = {   # PERF.md's kernel table, at the paths' shapes
    "fedavg": (lambda: fedavg_ops.cost(4, 152064 * 3584, BF16), "1.627"),
    "flash": (lambda: flash_ops.cost(1, 2048, 2048, 28, 4, 128, BF16,
                                     True), "0.0304"),
    "qagg": (lambda: fedavg_ops.qagg_cost(4, 152064, 3584), "1.302"),
    "quantize": (lambda: quant8_ops.quantize_cost(152064 * 3584, BF16),
                 "0.491"),
    "dequantize": (lambda: quant8_ops.dequantize_cost(152064 * 3584),
                   "0.816"),
    "wkv6": (lambda: wkv_ops.cost(1, 2048, 64, 64, 64, 128, 64, True, False,
                                  BF16), "0.0354"),
    "ssm_scan": (lambda: wkv_ops.cost(1, 2048, 25, 16, 64, 128, 1, False,
                                      False, BF16), "0.00547"),
}


@pytest.mark.parametrize("kernel", list(KERNEL_BOUNDS))
def test_kernel_cost_gives_the_printed_bound(kernel):
    cost, printed = KERNEL_BOUNDS[kernel]
    digits = len(printed.split(".")[1])
    assert f"{_bound_ms(cost()):.{digits}f}" == printed


@pytest.mark.parametrize("case", [
    (300, 300, True, 64, 0, 0), (64, 192, True, None, 128, 0),
    (100, 50, False, None, 0, 0), (100, 50, False, 7, 3, 9),
    (37, 80, True, 5, 40, 2), (2048, 2048, True, 1024, 0, 0)])
def test_flash_pairs_equal_the_mask_count(case):
    Sq, Sk, causal, window, qo, ko = case
    qp = qo + np.arange(Sq)[:, None]
    kp = ko + np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= qp >= kp
    if window is not None:
        keep &= qp - kp < window
    assert flash_ops.pairs(*case) == int(keep.sum())


def test_meta_kernel_calls_report_cost_and_launch_nothing():
    before = (fedavg_ops.launches, flash_ops.launches,
              wkv_ops.launches_u, wkv_ops.launches_ssd,
              quant8_ops.quantize_launches)
    m = lambda *s, dtype=BF16: torch.empty(s, dtype=dtype, device="meta")
    with OpCounter() as oc:
        out = fedavg_ops.fedavg(m(4, 1000), m(4, dtype=torch.float32))
        o, lse = flash_ops.flash_fwd(m(1, 96, 4, 32), m(1, 96, 2, 32),
                                     m(1, 96, 2, 32))
        y, s = wkv_ops.wkv(m(1, 100, 2, 16), m(1, 100, 2, 16),
                           m(1, 100, 2, 32),
                           m(1, 100, 2, 16, dtype=torch.float32),
                           u=m(2, 16, dtype=torch.float32), chunk=64)
        q, sc, n = quant8_ops.quantize(m(1000))
    assert (fedavg_ops.launches, flash_ops.launches, wkv_ops.launches_u,
            wkv_ops.launches_ssd, quant8_ops.quantize_launches) == before
    assert out.shape == (1000,) and out.device.type == "meta"
    assert o.shape == (1, 96, 4, 32) and lse.shape == (1, 4, 96)
    assert y.shape == (1, 100, 2, 32) and s.shape == (1, 2, 16, 32)
    assert q.shape == (256, 256) and sc.shape == (256,) and n == 1000
    k = oc.cost.kernels
    assert {name: v["launches"] for name, v in k.items()} == {
        "fedavg": 1, "flash_fwd": 1, "wkv6": 1, "quantize": 1}
    assert k["flash_fwd"]["flops"] == flash_ops.cost(
        1, 96, 96, 4, 2, 32, BF16)[0]
    assert k["wkv6"]["bytes"] == wkv_ops.cost(1, 100, 2, 16, 32, 64, 16,
                                              True, False, BF16)[1]


def test_kernel_cost_is_not_worked_out_without_a_counter(monkeypatch):
    """A kernel call reports its ``cost()`` only to an active op counter:
    with none, the cost function is not called."""
    def cost(*a):
        raise AssertionError("cost() worked out with no counter active")
    monkeypatch.setattr(flash_ops, "cost", cost)
    q = torch.empty((1, 8, 2, 4), dtype=BF16, device="meta")
    o, _ = flash_ops.flash_fwd(q, q, q)
    assert o.shape == q.shape


# --------------------------------------------------------------------------
# a traced cell
# --------------------------------------------------------------------------

def _smoke_overrides(arch: str) -> dict:
    cfg, sm = get_arch(arch), smoke_config(get_arch(arch))
    out = {f.name: getattr(sm, f.name) for f in dataclasses.fields(cfg)
           if getattr(sm, f.name) != getattr(cfg, f.name)}
    return out | {"remat": True}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lower_cell_traces_a_smoke_cell(kind):
    """qwen2-7b's smoke config (remat on) at 128 tokens, past its flash
    threshold, on a (2, 2) mesh: ``ok``; a round's flash launches are
    the chip script's rule (forward and recompute, 2 a layer); prefill
    runs flash once a layer and decode none; a second call counts the
    same; no process group is left, and one that exists makes it raise."""
    ov = _smoke_overrides("qwen2-7b")
    shape = ShapeConfig(f"smoke_{kind}", 128, 4, kind)
    rec = dryrun.lower_cell("qwen2-7b", shape, False, overrides=ov,
                            mesh_shape={"data": 2, "model": 2})
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    layers = ov["n_layers"]
    flash = rec["kernels"].get("flash_fwd", {}).get("launches", 0)
    assert flash == {"train": 2 * layers, "prefill": layers,
                     "decode": 0}[kind]
    mem = rec["memory"]
    assert mem["total_per_device"] >= mem["argument_size_in_bytes"] > 0
    rf = rec["roofline"]
    assert rf["flops_per_dev"] > 0 and rf["collective_counts"]
    assert set(rf["collective_by_group"]) <= {
        f"{k}/2" for k in ("all-reduce", "all-gather", "reduce-scatter")}
    again = dryrun.lower_cell("qwen2-7b", shape, False, overrides=ov,
                              mesh_shape={"data": 2, "model": 2})
    for key in ("kernels", "memory", "roofline", "op_cost",
                "params_per_rank"):
        assert again[key] == rec[key], key
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=4)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            dryrun.lower_cell("qwen2-7b", shape, False, overrides=ov,
                              mesh_shape={"data": 2, "model": 2})
    finally:
        dist.destroy_process_group()
