"""Checkpoint manager: keep-N rotation, latest-committed discovery,
auto-resume — the restart half of fault tolerance."""
from __future__ import annotations

import os
import re
import shutil

from repro_torch.ckpt.checkpoint import (is_committed, restore_checkpoint,
                                         save_checkpoint)

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, every: int = 1):
        self.dir = directory
        self.keep = keep
        self.every = every
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and is_committed(os.path.join(self.dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def should_save(self, step: int) -> bool:
        return step % self.every == 0

    def save(self, step: int, state, meta: dict | None = None) -> str:
        meta = dict(meta or {}, step=step)
        path = save_checkpoint(os.path.join(self.dir, f"step_{step}"),
                               state, meta)
        self._gc()
        return path

    def _gc(self):
        steps = self._steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, state):
        """Copy the newest committed checkpoint into ``state`` in place.
        Returns (state, meta), or (None, None) when nothing is committed."""
        s = self.latest_step()
        if s is None:
            return None, None
        meta = restore_checkpoint(os.path.join(self.dir, f"step_{s}"), state)
        return state, meta
