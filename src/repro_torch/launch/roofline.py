"""Roofline terms of one rank's step, from its ``OpCost``
(``launch/op_analysis.py``), with the H100's constants
(``launch/mesh.py``):

  compute term    = FLOPs / 989 TFLOP/s (dense bf16)
  memory term     = HBM bytes / 3.35 TB/s
  collective term = NVLink wire bytes / NVLINK_BW
                    + cross-node wire bytes / NET_BW

The reference's ``launch/roofline.py`` with its TPU v5e constants swapped
for these and its ICI/DCN split for NVLink inside a node and the network
across nodes.  Every term is one rank's, so dividing by one card's peak is
the total over (cards x peak).  The memory term is the eager count
(``op_analysis``), an upper bound on what a fused step would move.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import (HBM_BW, NET_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.launch.op_analysis import OpCost


@dataclass
class Roofline:
    cost: OpCost                       # one rank's
    n_devices: int
    model_flops_total: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.cost.flops / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.cost.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        cross = self.cost.coll_cross_node_bytes
        return (self.cost.coll_bytes - cross) / NVLINK_BW + cross / NET_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over every card: what remat,
        replicated work and the attention's own FLOPs add to 6·N·D."""
        total = self.cost.flops * self.n_devices
        return self.model_flops_total / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful_compute_time / bound_time: the share of the ideal
        (model-FLOPs-only) roofline this step reaches if it runs at its
        dominant term's speed."""
        useful_s = (self.model_flops_total / self.n_devices) / PEAK_FLOPS_BF16
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        c = self.cost
        return {
            "flops_per_dev": c.flops,
            "hbm_bytes_per_dev": c.hbm_bytes,
            "collective_bytes": c.coll_bytes,
            "collective_cross_node_bytes": c.coll_cross_node_bytes,
            "collective_per_op": c.coll_per_op,
            "collective_counts": c.coll_counts,
            "collective_by_group": c.coll_by_group,
            "hbm_per_op": {k: round(v) for k, v in c.hbm_per_op.items()},
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward."""
    if kind == "train":
        return 6.0 * n_params_active * n_tokens
    return 2.0 * n_params_active * n_tokens


def build_roofline(cost: OpCost, n_devices: int,
                   model_flops_total: float) -> Roofline:
    return Roofline(cost, n_devices, model_flops_total)
