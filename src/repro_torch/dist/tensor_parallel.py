"""Tensor parallelism over the mesh's ``model`` axis inside a client, for
every family: the dense, MoE and VLM decoders, the encoder-decoder, RWKV6
and Hymba.

The reference has no file for this: it declares each parameter's logical
axes (``vocab``, ``heads``, ``kv_heads`` and ``mlp`` map to ``model``,
``dist/sharding.rules_for``), and GSPMD's partitioner splits the math and
inserts the collectives.  Here the split is written out, in the usual
column- and row-parallel form, over the process group of the client's M
ranks (``launch.mesh.Mesh.group("model")``):

* a column-parallel projection (``wq``/``wk``/``wv`` and their biases,
  ``w_gate``/``w_up``, the output table's vocab rows) takes its input
  through ``copy_to_model``: identity forward, all-reduce of the input's
  gradient backward;
* a row-parallel projection (``wo``, ``w_down``) computes its partial
  product in f32 and all-reduces it (``row_parallel``); its backward is
  the plain product's.  The reduction runs in f32: each element is then
  rounded to bf16 once, after the sum, as the single device's one GEMM
  rounds it (a bf16 all-reduce would round each partial first).  At
  qwen2-7b's (2048, 3584) activations that is 29 MB an all-reduce;
* the embedding is vocab-parallel (``embed_lookup``: each rank looks up
  the tokens in its rows, zeros elsewhere, then an all-reduce), and so is
  the cross-entropy over the padded vocab (``cross_entropy``: the max, the
  sum of exponentials and the label's logit, each reduced over the model
  axis, all in f32), the same function as ``model_api.cross_entropy``.

* the MoE layer (``models/moe.moe_apply_dense``) takes the form the
  expert leaves' specs give it (``moe_split``, ``_spec_for``'s rule: the
  experts claim the axis first, their FFN width where the experts do not
  divide it).  Expert parallelism: each rank holds E/M experts and the
  router's (D, E/M) columns; it all-gathers the router
  (``gather_from_model``), so routing, dispatch, capacity and the
  auxiliary loss are the single device's on every rank, runs its own E/M
  rows of the whole (E, cap, D) dispatch buffer, and all-gathers their
  outputs before the single device's combine.  Intra-expert tensor
  parallelism: the ``swiglu`` form above batched over the experts (the
  router whole).  Only the dispatch's input goes through
  ``copy_to_model``: the router's own path to x has its whole gradient
  on every rank already.

Every activation, and every activation's gradient, is then whole and equal
on the client's ranks, and a replicated weight (the norms) gets its whole
gradient on each.  An all-gather's backward takes the rank's slice of a
gradient that is whole on every rank: nothing is summed.  Adafactor's
factor means and its RMS clip over a split dim sum over the model group
(``optim/api.adafactor``, through ``ModelAxis.all_reduce``).  Where
``kv_heads`` stays whole while ``heads`` is split
(fewer kv heads than ranks, ``_spec_for``'s rule), a rank's q heads all
read one kv head (q head h reads kv head ``h // (H / Kv)``), which it
selects; those weights (``wk``, ``wv``, ``bk``, ``bv``) take
``copy_to_model`` too, so each gets the sum of its ranks' parts: its
gradient counted once.

RWKV6's time mix and Hymba's SSM branch split on heads as the attention
does: the projections into heads column-parallel, the recurrence (the WKV
kernel) on the rank's heads with their block of ``u``, the per-head norms
local, the projection out of heads row-parallel.  Their inputs that a
replicated leaf computes whole (RWKV6's ddlerp streams and its decay,
Hymba's normed input and its conv's weights, whose ``embed`` dim a model
axis does not split) take ``copy_to_model`` before the rank's part is
used, so the replicated leaf gets its whole gradient on every rank.
RWKV6's channel mix declares ``cm.wr`` (embed, mlp): its output columns
split, and the rank's columns of the gate are gathered
(``gather_from_model``).

Each dim is decided alone, as ``sharding._spec_for`` decides it.  Where
the heads do not divide the axis (hymba-1.5b's 25 at M = 2 or 4) they
stay whole, and so do the kv heads: the attention, the time mix and the
SSM branch then run their plain code on every rank, with no collective
(``heads_axis`` returns None for them).  Only the ``mlp`` and ``vocab``
dims (and the experts) must split; a config where one would stay whole
raises.

The encoder-decoder splits its encoder's and its decoder's attention on
heads, its GELU MLP as ``swiglu`` (the replicated output bias added once,
after the row-parallel sum), and its cross-attention as the attention,
the encoder's memory taken through ``copy_to_model`` by every decoder
layer's key and value projection.  The VLM's patch projection, declared
(``mlp``, ``embed``), is row-parallel over its ``feat_dim`` input.

With a model axis of 1 there is no :class:`ModelAxis` (``axis_for``
returns None) and the model runs its plain code.  A config whose ``mlp``
or ``vocab`` would stay whole raises ``NotImplementedError``
(``check_supported``).  In ``shared`` mode the parameters are also
split on ``data`` (``dist/fsdp.py``), and each layer gathers them there
before this code sees them: a gathered leaf is a model block as here.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig

def _splits(n: int, size: int) -> bool:
    """Whether a dim of ``n`` takes a mesh axis of ``size`` (the rule of
    ``sharding._spec_for``)."""
    return n >= size and n % size == 0


def moe_split(cfg: ArchConfig, size: int) -> Optional[str]:
    """The MoE dim a model axis of ``size`` splits: ``"experts"`` (expert
    parallelism) where the experts divide it, else ``"expert_mlp"``
    (intra-expert tensor parallelism) where their FFN width does, else
    None (``sharding._spec_for`` on the expert leaves)."""
    m = cfg.moe
    if _splits(m.n_experts, size):
        return "experts"
    return "expert_mlp" if _splits(m.d_ff_expert, size) else None


def head_counts(cfg: ArchConfig) -> tuple:
    """(q heads, kv heads) of the leaves on ``heads`` and ``kv_heads``:
    RWKV6's are its ``d_model / rwkv_head_dim`` heads (both)."""
    if cfg.family == "rwkv":
        h = cfg.d_model // cfg.rwkv_head_dim
        return h, h
    return cfg.n_heads, cfg.n_kv_heads


def _mlp_widths(cfg: ArchConfig) -> list:
    """The widths of the ``mlp`` leaves the config holds: the dense FFN
    (Whisper's GELU MLP too), or an MoE config's leading dense layers and
    its shared expert; RWKV6's channel mix also declares ``cm.wr``'s
    output, ``d_model``, on ``mlp``, and the VLM its patch projection's
    input, ``frontend.feat_dim``."""
    m = cfg.moe
    if cfg.family == "rwkv":
        return [cfg.d_ff, cfg.d_model]
    if cfg.family == "vlm":
        return [cfg.d_ff, cfg.frontend.feat_dim]
    if m is None:
        return [cfg.d_ff]
    return ([m.d_ff_dense] if m.first_k_dense else []) + \
        ([m.n_shared_experts * m.d_ff_expert] if m.n_shared_experts else [])


def check_supported(cfg: ArchConfig, size: int):
    """Raises ``NotImplementedError`` for a config that a model axis of
    ``size`` > 1 does not run yet: one whose ``mlp`` or ``vocab`` (or its
    experts) would stay whole, or whose rank's q heads would read two kv
    groups."""
    from repro_torch.models.layers import pad_vocab
    whole = [] if _splits(pad_vocab(cfg.vocab), size) else ["vocab"]
    whole += ["mlp"] if not all(_splits(n, size)
                                for n in _mlp_widths(cfg)) else []
    if cfg.moe is not None and moe_split(cfg, size) is None:
        whole.append("experts and expert_mlp")
    if whole:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(whole)} would stay whole on a model "
            f"axis of {size}; tensor parallelism splits mlp (or the "
            "experts) and vocab (heads split or stay whole)")
    n_heads, n_kv = head_counts(cfg)
    group, local = n_heads // n_kv, n_heads // size
    if (_splits(n_heads, size) and not _splits(n_kv, size)
            and group % local):
        raise NotImplementedError(
            f"{cfg.name} on a model axis of {size}: a rank's {local} q heads "
            f"would read parts of two groups of {group}")


class GroupAxis:
    """One mesh axis of a client as its collectives see it: the process
    group of its ``size`` ranks and this rank's index ``rank`` in it.
    ``events``, when a list, collects a CUDA event pair around every
    collective (the round step reads their time)."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.events: Optional[list] = None

    def _timed(self, x: torch.Tensor, collective):
        """Runs ``collective()``; on the card, with ``events`` a list, inside
        a CUDA event pair appended to it."""
        if self.events is None or x.device.type != "cuda":
            collective()
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        collective()
        end.record()
        self.events.append((start, end))

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM):
        """In-place all-reduce of ``x`` over the group."""
        self._timed(x, lambda: dist.all_reduce(x, op=op, group=self.group))
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (a
        new tensor).  ``all_gather_into_tensor`` is in every torch this port
        runs on; newer ones warn that it is deprecated."""
        part = x.movedim(dim, 0).contiguous()
        out = part.new_empty((self.size * part.shape[0],) + part.shape[1:])

        def gather():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(out, part, group=self.group)
        self._timed(x, gather)
        return out.movedim(0, dim).contiguous()

    def sum_f32(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, in f32 (a new tensor)."""
        return self.all_reduce(x.to(torch.float32, copy=True).contiguous())


class ModelAxis(GroupAxis):
    """A client's model axis as the layers see it: its group, this rank's
    index ``rank`` in it, the global head counts, and whether the heads
    (``heads_split``) and the kv heads (``kv_split``) split over it."""

    def __init__(self, group, size: int, rank: int, n_heads: int,
                 n_kv: int):
        super().__init__(group, size, rank)
        self.n_heads, self.n_kv = n_heads, n_kv
        self.heads_split = _splits(n_heads, size)
        self.kv_split = _splits(n_kv, size)


def axis_for(cfg: ArchConfig, mesh) -> Optional[ModelAxis]:
    """The model axis of ``mesh`` for ``cfg``, or None (no mesh, or a
    model axis of 1).  Raises for what it does not run yet."""
    if mesh is None or mesh.shape["model"] == 1:
        return None
    size = mesh.shape["model"]
    check_supported(cfg, size)
    return ModelAxis(mesh.group("model"), size, mesh.coord("model"),
                     *head_counts(cfg))


def heads_split(cfg: ArchConfig, size: int) -> bool:
    """Whether ``cfg``'s heads split over a model axis of ``size``; where
    they do not, every block over heads runs whole on each rank
    (``heads_axis``)."""
    return _splits(head_counts(cfg)[0], size)


def heads_axis(tp: Optional[ModelAxis]) -> Optional[ModelAxis]:
    """The axis a block over heads (the attention, RWKV6's time mix,
    Hymba's SSM branch) splits its heads over: ``tp`` where the heads
    divide it, else None (the block runs whole on every rank)."""
    return tp if tp is not None and tp.heads_split else None


def head_columns(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """This rank's block of ``t``'s last dim, a whole dim laid out as
    (heads, per head): the columns of its heads (a view)."""
    n = t.shape[-1] // axis.size
    return t.narrow(-1, axis.rank * n, n)


# --------------------------------------------------------------------------
# the collectives, as autograd Functions
# --------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient is summed over the model group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum_f32(g).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group in f32, cast to ``dtype``; identity
    backward (every rank's part has the sum's gradient)."""

    @staticmethod
    def forward(ctx, x, axis, dtype):
        ctx.dtype = x.dtype
        return axis.sum_f32(x).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, or batched 3-D) with an f32 result: on a card, bf16
    or f16 operands go through the GEMM with an f32 output (no rounding to
    bf16); on the CPU, the product of the operands in f32 (the same
    value).  A meta tensor (a dry run) stands for the card's."""
    mm = torch.bmm if b.dim() == 3 else torch.mm
    if a.device.type in ("cuda", "meta") and a.dtype in (torch.bfloat16,
                                                         torch.float16):
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


class _GatherFromModel(torch.autograd.Function):
    """Every rank's part concatenated along ``dim``; the backward takes this
    rank's slice of the gradient, which is whole and equal on every rank
    (nothing to sum)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _RowParallel(torch.autograd.Function):
    """``x @ w`` where x's last dim and w's rows are this rank's part of
    the contraction: the partial product in f32, summed over the model
    group, cast to x's dtype.  The backward is the plain product's
    (``g @ w.T``, ``x.T @ g`` in x's dtype); g is equal on every rank.  A
    3-D ``w`` (E, F/M, D) is a batch of E products of a 3-D x (E, n, F/M),
    the experts' down projection."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.save_for_backward(x, w)
        if w.dim() == 3:
            return axis.all_reduce(_mm_f32(x, w)).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        y = axis.all_reduce(_mm_f32(x2, w))
        return y.to(x.dtype).view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if w.dim() == 3:
            g = g.to(x.dtype)
            return (torch.bmm(g, w.transpose(1, 2)),
                    torch.bmm(x.transpose(1, 2), g), None)
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w.t()).view(x.shape)
        dw = x.reshape(-1, x.shape[-1]).t() @ g2
        return dx, dw, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis,
                      dtype=None) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis, dtype or x.dtype)


def gather_from_model(x: torch.Tensor, axis: ModelAxis,
                      dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, axis, dim)


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 axis: ModelAxis) -> torch.Tensor:
    return _RowParallel.apply(x, w, axis)


# --------------------------------------------------------------------------
# vocab-parallel embedding and loss
# --------------------------------------------------------------------------

def _local_ids(ids: torch.Tensor, rows: int, axis: ModelAxis):
    """(ids shifted into this rank's ``rows`` vocab rows, clamped; the
    mask of the ids that fall in them)."""
    t = ids.long() - axis.rank * rows
    ok = (t >= 0) & (t < rows)
    return t.clamp(0, rows - 1), ok


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 axis: ModelAxis) -> torch.Tensor:
    """Rows of the vocab-split ``table`` for ``tokens``: each rank looks up
    the tokens in its rows (zeros for the others), then the sum over the
    model group, which holds the one row (exact)."""
    t, ok = _local_ids(tokens, table.shape[0], axis)
    rows = torch.where(ok[..., None], table[t], torch.zeros(
        (), dtype=table.dtype, device=table.device))
    return reduce_from_model(rows, axis)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  axis: ModelAxis) -> torch.Tensor:
    """``model_api.cross_entropy`` over vocab-split ``logits`` (B, S, V/M):
    the stop-gradient max, the sum of exponentials and the label's logit,
    each reduced over the model group, in f32."""
    lf = logits.float()
    m = axis.all_reduce(lf.amax(dim=-1, keepdim=True).detach(),
                        dist.ReduceOp.MAX)
    lse = torch.log(reduce_from_model(torch.exp(lf - m).sum(dim=-1), axis)) \
        + m[..., 0]
    t, ok = _local_ids(labels, lf.shape[-1], axis)
    picked = lf.gather(-1, t[..., None])[..., 0]
    label_logit = reduce_from_model(torch.where(ok, picked, 0.0), axis)
    return (lse - label_logit).mean()


# --------------------------------------------------------------------------
# attention's kv heads
# --------------------------------------------------------------------------

def kv_index(axis: ModelAxis, local_heads: int) -> Optional[torch.Tensor]:
    """Where ``kv_heads`` stays whole: the one kv head this rank's
    ``local_heads`` q heads read (``check_supported`` holds them in one
    group), as an index into the whole kv axis; None where kv is split."""
    if axis.kv_split:
        return None
    return torch.tensor([axis.rank * local_heads
                         // (axis.n_heads // axis.n_kv)])
