"""Hyperparameter strategy generation: initial sizing + runtime refinement.
The port's own copy of dlrover_tpu/master/hyperparams.py.

The initial DataLoader/optimizer config comes from node resources; at run
time the micro-batch grows from observed memory headroom, with the
optimizer's learning rate and weight decay coupled to the batch by the
sqrt scaling rule. The knobs are the trainer's micro-batch and grad-accum
(the accumulation keeps the global batch), sized against a transformer
activation-memory model that accounts for rematerialization. The
arithmetic, the defaults (``hbm_per_chip_gb``, ``chips_per_host``) and the
paral-config keys are the JAX package's, so both packages suggest the same
strategy from the same report.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ModelProfile:
    """What the worker reports about its model (ModelInfoReport)."""

    param_count: int = 0
    seq_len: int = 0
    hidden_dim: int = 0
    n_layers: int = 0
    n_heads: int = 0
    dtype_bytes: int = 2  # bf16 activations
    remat: bool = True

    def complete(self) -> bool:
        return self.seq_len > 0 and self.hidden_dim > 0 and self.n_layers > 0


def activation_bytes_per_sample(mp: ModelProfile) -> float:
    """Per-sample activation memory of one transformer microbatch element.

    Reference formula (``simple_strategy_generator.py:104-115``):
    ``(34*s*d + 5*s^2*h) * n_layer`` elements; here scaled by the
    activation dtype and the rematerialization policy — with full-layer
    remat only the layer *boundaries* stay resident (one ``s*d`` tensor
    per layer) plus one layer's working set during recompute."""
    if not mp.complete():
        return 0.0
    s, d, h = mp.seq_len, mp.hidden_dim, max(1, mp.n_heads)
    per_layer = (34.0 * s * d + 5.0 * s * s * h) * mp.dtype_bytes
    if mp.remat:
        boundaries = mp.n_layers * s * d * mp.dtype_bytes
        return boundaries + per_layer  # one layer's working set at a time
    return per_layer * mp.n_layers


@dataclass
class StrategySuggestion:
    micro_batch_size: int
    grad_accum_steps: int
    learning_rate: float
    dataloader_workers: int
    weight_decay: float = 0.0

    def to_paral_config(self) -> Dict:
        out = {
            "dataloader_batch_size": self.micro_batch_size,
            "dataloader_num_workers": self.dataloader_workers,
            "optimizer_learning_rate": self.learning_rate,
            "grad_accum_steps": self.grad_accum_steps,
        }
        if self.weight_decay:
            out["optimizer_weight_decay"] = self.weight_decay
        return out


class SimpleStrategyGenerator:
    def __init__(
        self,
        hbm_per_chip_gb: float = 95.0,  # v5p
        chips_per_host: int = 4,
        host_memory_floor_mb: float = 2400.0,
    ):
        self._hbm_gb = hbm_per_chip_gb
        self._chips_per_host = chips_per_host
        #: never grow into the last slice of host memory (reference keeps
        #: a >2400MB guard so a growth step cannot OOM the host)
        self._floor_mb = host_memory_floor_mb

    # -- initial strategy (job create time) ------------------------------

    def generate_opt_strategy(
        self,
        global_batch_size: int,
        world_hosts: int,
        base_lr: float = 3e-4,
        base_world: int = 1,
        model_bytes_per_sample: float = 0.0,
        model: Optional[ModelProfile] = None,
        host_cpus: int = 0,
    ) -> StrategySuggestion:
        if model is not None and model.complete():
            model_bytes_per_sample = (
                model_bytes_per_sample or activation_bytes_per_sample(model)
            )
        chips = max(1, world_hosts * self._chips_per_host)
        per_chip_batch = max(1, global_batch_size // chips)
        if model_bytes_per_sample > 0:
            # keep activations under ~1/4 of HBM
            cap = max(1, int(self._hbm_gb * 1e9 * 0.25 / model_bytes_per_sample))
            per_chip_batch = min(per_chip_batch, cap)
        micro = per_chip_batch * self._chips_per_host  # per-host micro batch
        accum = max(1, global_batch_size // max(1, micro * world_hosts))
        # linear scaling rule for lr with world growth
        lr = base_lr * (world_hosts / max(1, base_world)) ** 0.5
        return StrategySuggestion(
            micro_batch_size=micro,
            grad_accum_steps=accum,
            learning_rate=lr,
            dataloader_workers=self._dataloader_workers(host_cpus),
        )

    def _dataloader_workers(self, host_cpus: int) -> int:
        """Input pipeline parallelism from the host's CPU budget: one
        worker per chip feeds the device transfer, capped so the loader
        never starves the main process (reference sizes workers from node
        resources)."""
        if host_cpus > 0:
            return max(2, min(host_cpus - 1, 2 * self._chips_per_host))
        return min(8, max(2, self._chips_per_host))

    # -- runtime refinement (running stage) ------------------------------

    def refine_strategy(
        self,
        current: Dict,
        model: ModelProfile,
        host_mem_used_mb: float,
        host_mem_total_mb: float,
    ) -> Optional[StrategySuggestion]:
        """Grow the micro-batch 2x (halving grad-accum) when it is safe.

        Reference ``_generate_dataloader_config`` grows the batch from
        remaining memory; the TPU translation bounds growth by what
        actually limits a TPU job:

        - **HBM (analytic)**: the doubled micro-batch's activations must
          stay under ~1/4 of HBM per chip — the same cap the initial
          strategy used; host-RAM headroom cannot see HBM, so this is
          computed from the model profile, not observed memory;
        - **global-batch invariance**: growth happens ONLY by moving a
          factor of 2 from grad-accum into the micro-batch (accum must
          be even), so the global batch — and training semantics — never
          drift, and growth stops naturally at accum=1;
        - **host RAM floor**: the larger per-step host buffers must not
          crowd the last ``host_memory_floor_mb`` of RAM.

        With an even accum >= 2 the growth is an accum shift: the global
        batch is untouched, so lr/wd stay untouched too. At accum == 1
        the growth genuinely doubles the global batch (the reference's
        case), and lr AND weight decay scale by sqrt(batch ratio)
        (``_generate_optimizer_config``). Returns None when any bound
        says hold."""
        batch = int(current.get("dataloader_batch_size", 0) or 0)
        accum = int(current.get("grad_accum_steps", 1) or 1)
        act = activation_bytes_per_sample(model)
        if batch <= 0 or act <= 0:
            return None
        if accum > 1 and accum % 2:
            return None  # odd accum: no exact factor-2 shift possible
        if host_mem_total_mb - host_mem_used_mb <= self._floor_mb:
            return None
        grown = batch * 2
        per_chip = -(-grown // self._chips_per_host)  # ceil
        if per_chip * act > self._hbm_gb * 1e9 * 0.25:
            return None  # doubled activations would not fit HBM budget
        lr = float(current.get("optimizer_learning_rate", 0.0) or 0.0)
        wd = float(current.get("optimizer_weight_decay", 0.0) or 0.0)
        if accum >= 2:
            # accum shift: global batch (and training semantics) invariant
            new_accum, coeff = accum // 2, 1.0
        else:
            # true global-batch growth: couple the optimizer
            new_accum, coeff = 1, math.sqrt(2.0)
        return StrategySuggestion(
            micro_batch_size=grown,
            grad_accum_steps=new_accum,
            learning_rate=lr * coeff if lr else 0.0,
            dataloader_workers=int(
                current.get("dataloader_num_workers", 0) or 0
            ) or self._dataloader_workers(0),
            weight_decay=wd * coeff if wd else 0.0,
        )
