"""Batched serving engine: a loop over a fixed batch of slots (prefill on
admit, decode every step).  Used by ``launch/serve.py`` and
``examples/serve_lm.py``; the prefill and decode functions are the model
families' own (``model_api.get_model``).

The reference jits prefill and decode; here both run eagerly under
``torch.inference_mode`` on the engine's device, and decode updates the
cache in place.  A step's greedy tokens stay on the device until the
batch ends, so the host never waits for the card between steps.

On a mesh (``launch.mesh.Mesh``) the engine is one rank of the
reference's serving layout (``launch/dryrun.py``): its parameters are the
rank's blocks under ``model_api.serve_specs`` (``init_params(...,
mesh=)``), a batch's rows split over ``data`` where the batch size divides
it (``inputs.rank_rows``' rule), and the cache is the rank's block of the
family's ``cache_decl`` (``kvcache.cache_specs``: split on its sequence,
its kv heads, or whole).  The layers run tensor-parallel over ``model``
(``dist/tensor_parallel.py``) and, in ``shared`` mode, gather their
weights over ``data`` (``dist/fsdp.py``); an MoE layer routes the whole
batch.  Every rank takes the argmax of the whole logits, and at a batch's
end the rows' tokens are gathered over ``data``, so ``run`` returns the
same completed requests on every rank.  The encoder-decoder's cache
holds two layouts, its self-attention's (``layout``) and its cross
cache's (``cross_layout``), each from its own keys' spec.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
from repro_torch.dist import fsdp
from repro_torch.dist import tensor_parallel as tpar
from repro_torch.models import kvcache as kvc
from repro_torch.models import model_api


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-batch decode engine with prompt prefill.

    Every admitted batch prefills together (left-padded with token 0 to
    the longest prompt); decode then proceeds one token per step for all
    slots.  Greedy sampling.  ``mesh``, when given, is a rank's
    (``launch.mesh.Mesh``) and ``params`` its blocks: the engine serves
    on its card (module docstring).  A full-attention cache gets
    ``min(S + max_new + 1, max_seq)`` slots at prefill; a windowed one
    keeps its prefilled length and wraps, as the reference does (ROADMAP
    R4; ``kvcache.serve_cache_len``)."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_seq: int = 256, device="cuda", mesh=None):
        self.tp = tpar.axis_for(cfg, mesh)      # raises on what it lacks
        self.data = None
        if mesh is not None and mesh.shape["data"] > 1:
            self.data = fsdp.DataAxis(
                mesh.group("data"), mesh.shape["data"], mesh.coord("data"),
                fsdp.data_dims(model_api.serve_specs(cfg, mesh)))
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self.model = model_api.get_model(cfg)
        self.layout = None              # the current batch's cache layout,
        self.cross_layout = None        # its cross cache's (encoder-decoder)
        self._dp = None                 # and its data axis
        self.queue: collections.deque[Request] = collections.deque()
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "requests": 0, "decode_s": 0.0, "prefill_s": 0.0}

    def submit(self, prompt: np.ndarray, max_new: int = 16) -> Request:
        r = Request(self.stats["requests"], np.asarray(prompt, np.int32),
                    max_new)
        self.stats["requests"] += 1
        self.queue.append(r)
        return r

    def _extra_inputs(self, B, S):
        """The frontend stub's inputs, zeros in bf16 as in the reference:
        frames for the encoder-decoder, patches filling up to S positions
        for the VLM."""
        fe = self.cfg.frontend

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.bfloat16,
                               device=self.device)
        if self.cfg.family == "encdec":
            return {"frames": zeros(B, fe.n_tokens, fe.feat_dim)}
        if self.cfg.family == "vlm":
            return {"patches": zeros(B, min(fe.n_tokens, S), fe.feat_dim)}
        return {}

    def run(self) -> list[Request]:
        """Drain the queue; returns completed requests."""
        done = []
        while self.queue:
            batch = [self.queue.popleft()
                     for _ in range(min(self.B, len(self.queue)))]
            done.extend(self._run_batch(batch))
        return done

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _split(self, B: int) -> bool:
        """Whether a batch of ``B`` rows splits over the data axis (its
        size divides B: ``inputs.rank_rows``' rule)."""
        return self.data is not None and B % self.data.size == 0

    def rows(self, B: int) -> slice:
        """The rows of a batch of ``B`` this rank serves."""
        if not self._split(B):
            return slice(0, B)
        n = B // self.data.size
        return slice(self.data.rank * n, (self.data.rank + 1) * n)

    def _kw(self):
        """The rank's arguments of a family's prefill and decode: the
        model and data axes and the cache layouts (none, and ``whole``, on
        one device)."""
        kw = {"tp": self.tp, "dp": self._dp, "layout": self.layout}
        if self.cross_layout is not None:
            kw["cross_layout"] = self.cross_layout
        return kw

    @torch.inference_mode()
    def prefill(self, tokens: np.ndarray, max_new: int):
        """Prefill the batch ``tokens`` (B, S) (left-padded prompts) ->
        (the logits (b, V) of this rank's rows (``rows``), their cache),
        the cache sized for ``max_new`` new tokens; sets the batch's
        ``layout`` for ``decode``."""
        cfg, dev = self.cfg, self.device
        B, S = tokens.shape
        batch = {"tokens": torch.from_numpy(
            np.ascontiguousarray(tokens[self.rows(B)])).to(dev)}
        batch.update(self._extra_inputs(batch["tokens"].shape[0], S))
        self.plan(B, kvc.serve_cache_len(cfg, S, max_new, self.max_seq))
        return self.model.prefill(cfg, self.params, batch, **self._kw())

    def plan(self, B: int, C: int) -> None:
        """Lays out a batch of ``B`` rows with a cache of ``C`` slots: the
        batch's data axis and its cache ``layout`` (and ``cross_layout``)
        for ``prefill`` and ``decode``."""
        self._dp = None if self.data is None else self.data.with_split(
            self._split(B))
        decls = self.model.cache_decl(self.cfg, B, max(C, 1))
        self.layout = kvc.layout_for(self.cfg, decls, self.mesh)
        self.cross_layout = kvc.layout_for(self.cfg, decls, self.mesh,
                                           "cross_")

    @torch.inference_mode()
    def decode(self, cache, token: torch.Tensor, pos: int) -> torch.Tensor:
        """One decode step of this rank's rows: ``token`` (b,) at position
        ``pos`` -> the logits (b, V); the cache is updated in place."""
        dbatch = {"token": token.to(torch.int32)[:, None],
                  "pos": torch.full(token.shape, pos, dtype=torch.int32,
                                    device=self.device)}
        return self.model.decode_step(self.cfg, self.params, cache, dbatch,
                                      **self._kw())[0]

    @torch.inference_mode()
    def _run_batch(self, reqs: list[Request]) -> list[Request]:
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new for r in reqs)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt      # left-pad
        t0 = time.perf_counter()
        logits, cache = self.prefill(toks, max_new)
        cur = logits.argmax(-1).to(torch.int32)
        self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += B * S
        t0 = time.perf_counter()
        outs = []
        for step in range(max_new):
            outs.append(cur)
            cur = self.decode(cache, cur, S + step).argmax(-1).to(
                torch.int32)
            self.stats["decode_steps"] += 1
        if outs:
            tokens = torch.stack(outs, dim=1)
            if self._dp is not None and self._dp.split:  # every rank's rows
                tokens = self._dp.all_gather(tokens, 0)
            tokens = tokens.tolist()
        else:
            tokens = [[]] * B
        self._sync()
        self.stats["decode_s"] += time.perf_counter() - t0
        for r, row in zip(reqs, tokens):
            r.out.extend(row[:r.max_new])
            r.done = True
        return reqs
