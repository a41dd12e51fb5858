"""ElasticTrainer, single device (port of dlrover_tpu/train/trainer.py's
step path).

One optimizer step is ``accum_steps = global_batch // micro_batch``
microbatches (data-parallel size 1 for now): each microbatch's gradients
add into an f32 accumulator, the sum is scaled by 1/accum, clipped by its
global norm, fed to adamw, and the update is scaled by the state's
``lr_scale`` before it lands on the params, as the JAX step does. With one
microbatch the grads stay in the param dtype and no accumulator exists.

Unlike the JAX step, which returns a fresh state, this one updates the
state in place to save memory: the first microbatch's f32 gradients
become the accumulator, later ones add into it, the optimizer reuses the
gradient buffers for its update, and params and adam moments change where
they lie. ``step`` returns the same state dict it was given.

Meshes, zero-1, hierarchical collectives, warm compile, remesh and the
lint hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Tuple

import torch

from dlrover_tpu_torch.common.tree import Tree, flatten
from dlrover_tpu_torch.train.optim import make_optimizer

LossFn = Callable[[Tree, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class TrainConfig:
    global_batch_size: int = 32
    micro_batch_size: int = 4
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95


class ElasticTrainer:
    """Owns the optimizer and runs the accumulate-clip-adamw step."""

    def __init__(self, loss_fn: LossFn, train_config: TrainConfig):
        self.loss_fn = loss_fn
        self.tc = train_config
        self.optimizer = make_optimizer(train_config)

    @property
    def accum_steps(self) -> int:
        micro = self.tc.micro_batch_size
        if self.tc.global_batch_size % micro:
            raise ValueError(
                f"global_batch={self.tc.global_batch_size} not divisible by "
                f"micro_batch={micro}"
            )
        return self.tc.global_batch_size // micro

    @property
    def step_batch_shape(self) -> Tuple[int, int]:
        """(accum_steps, micro_batch): how callers shape the token batch
        fed to ``step``."""
        return self.accum_steps, self.tc.micro_batch_size

    def init_state(self, params: Tree) -> dict:
        """Train state around ``params``, whose leaves become the leaves
        that autograd differentiates (``requires_grad``)."""
        for _, p in flatten(params):
            p.requires_grad_(True)
        return {
            "params": params,
            "opt": self.optimizer.init(params),
            "step": 0,
            # runtime lr multiplier applied to the optimizer's updates
            "lr_scale": 1.0,
        }

    def step(self, state: dict, batch: torch.Tensor
             ) -> Tuple[dict, torch.Tensor]:
        """One optimizer step over ``batch`` shaped (accum_steps, micro,
        ...). Returns the (updated in place) state and the mean microbatch
        loss as a 0-dim tensor on the params' device."""
        accum = self.accum_steps
        if batch.shape[0] != accum:
            raise ValueError(
                f"batch leads with {batch.shape[0]}, expected accum_steps="
                f"{accum}"
            )
        leaves = flatten(state["params"])
        tensors = [p for _, p in leaves]
        loss_sum = None
        grads = None
        for i in range(accum):
            loss = self.loss_fn(state["params"], batch[i])
            g = torch.autograd.grad(loss, tensors)
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if grads is None:
                # accum == 1 keeps grads in the param dtype; otherwise the
                # first microbatch's f32 grads are the accumulator (0 + g0)
                grads = list(g) if accum == 1 else [t.float() for t in g]
            else:
                for acc, t in zip(grads, g):
                    acc.add_(t)
            del g
        if accum > 1:
            scale = 1.0 / accum
            for acc in grads:
                acc.mul_(scale)
        self.optimizer.step(
            state["params"], {path: g for (path, _), g in zip(leaves, grads)},
            state["opt"], lr_scale=state["lr_scale"],
        )
        state["step"] += 1
        return state, loss_sum * (1.0 / accum)

    @torch.no_grad()
    def eval_step(self, state: dict, batch: torch.Tensor) -> torch.Tensor:
        """Loss of one microbatch without touching the train state."""
        return self.loss_fn(state["params"], batch)

    def evaluate(self, state: dict, batches: Iterable[torch.Tensor]) -> float:
        """Mean loss over eval batches, each one ``step_batch_shape`` row.
        Losses add on the device and reach the host once, at the end."""
        total = None
        count = 0
        for batch in batches:
            loss = self.eval_step(state, batch)
            total = loss if total is None else total + loss
            count += 1
        if count == 0:
            raise ValueError("evaluate() got zero batches")
        return float(total) / count

