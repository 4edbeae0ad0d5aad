"""Batched serving engine: a loop over a fixed batch of slots (prefill on
admit, decode every step).  Used by ``launch/serve.py`` and
``examples/serve_lm.py``; the prefill and decode functions are the model
families' own (``model_api.get_model``).

The reference jits prefill and decode; here both run eagerly under
``torch.inference_mode`` on the engine's device, and decode updates the
cache in place.  A step's greedy tokens stay on the device until the
batch ends, so the host never waits for the card between steps.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve
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
    slots.  Greedy sampling.  A full-attention cache is grown to
    ``min(S + max_new + 1, max_seq)`` after prefill; a windowed one is
    left at its prefilled length and wraps, as the reference does
    (ROADMAP R4)."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int = 4,
                 max_seq: int = 256, device="cuda"):
        self.device = resolve(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self.model = model_api.get_model(cfg)
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

    @torch.inference_mode()
    def _run_batch(self, reqs: list[Request]) -> list[Request]:
        cfg, dev = self.cfg, self.device
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new for r in reqs)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt      # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        batch.update(self._extra_inputs(B, S))
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(cfg, self.params, batch)
        if cfg.window is None and cfg.family != "rwkv":
            cache = kvc.pad_cache(cache, min(S + max_new + 1, self.max_seq))
        cur = logits.argmax(-1).to(torch.int32)
        self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += B * S
        t0 = time.perf_counter()
        outs = []
        for step in range(max_new):
            outs.append(cur)
            pos = torch.full((B,), S + step, dtype=torch.int32, device=dev)
            dbatch = {"token": cur[:, None], "pos": pos}
            logits, cache = self.model.decode_step(cfg, self.params, cache,
                                                   dbatch)
            cur = logits.argmax(-1).to(torch.int32)
            self.stats["decode_steps"] += 1
        tokens = torch.stack(outs, dim=1).tolist() if outs else [[]] * B
        self._sync()
        self.stats["decode_s"] += time.perf_counter() - t0
        for r, row in zip(reqs, tokens):
            r.out.extend(row[:r.max_new])
            r.done = True
        return reqs
