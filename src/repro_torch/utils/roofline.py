"""Three-term roofline model for one NVIDIA H100 SXM (80 GB HBM3).

    compute_s    = per_chip_FLOPs   / 989e12      (bf16 dense tensor-core
                   peak, NVIDIA's data sheet)
    memory_s     = per_chip_bytes   / 3.35e12     (HBM3 bandwidth)
    collective_s = per_chip_link_B  / 450e9       (NVLink 4: 18 links x
                   25 GB/s in one direction; the ring traffic model in
                   utils/cost.py already reduces each collective to
                   per-chip link bytes)

The constants are the card's, not the TPU v5e's of the reference
(``src/repro/utils/roofline.py``); the data-sheet rates assume the full
700 W power limit.  All inputs come from the per-rank cost of the traced
dry-run step (``utils/cost.py``: local shard shapes), so every term is
per-chip seconds for one step.  ``model_flops_ratio`` = MODEL_FLOPS /
counted FLOPs measures how much of the traced compute is "useful"
(remat recompute and dispatch waste show up here).
"""
from __future__ import annotations

import dataclasses

from .cost import StepCost

PEAK_FLOPS = 989e12          # bf16 dense per chip
HBM_BW = 3.35e12             # bytes/s per chip
LINK_BW = 450e9              # bytes/s per chip over NVLink, one direction


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float
    model_flops: float
    model_flops_ratio: float
    dominant: str
    step_s: float            # max of the three terms (perfect overlap)
    mfu: float               # model_flops / (chips · peak · step_s)

    @staticmethod
    def from_cost(cost: StepCost, *, chips: int, model_flops: float
                  ) -> "Roofline":
        c = cost.flops / PEAK_FLOPS
        m = cost.hbm_bytes / HBM_BW
        k = cost.collective_bytes / LINK_BW
        step = max(c, m, k, 1e-12)
        dom = {c: "compute", m: "memory", k: "collective"}[max(c, m, k)]
        ratio = model_flops / max(cost.flops * chips, 1.0)
        return Roofline(
            compute_s=c, memory_s=m, collective_s=k,
            flops=cost.flops, hbm_bytes=cost.hbm_bytes,
            collective_bytes=cost.collective_bytes,
            model_flops=model_flops, model_flops_ratio=ratio,
            dominant=dom, step_s=step,
            mfu=model_flops / (chips * PEAK_FLOPS * step))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_train(n_params_active: int, n_tokens: int) -> float:
    """6·N·D (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_forward(n_params_active: int, n_tokens: int) -> float:
    return 2.0 * n_params_active * n_tokens
