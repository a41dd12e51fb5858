"""ElasticTrainer, single device (port of dlrover_tpu/train/trainer.py's
step path).

One optimizer step is ``accum_steps = global_batch // micro_batch``
microbatches (data-parallel size 1 for now). A batch is a tensor (token ids
for the LM families) or a tree of tensors (an ``(images, labels)`` tuple for
the CV family) whose every leaf leads with ``accum_steps``; microbatch ``i``
is every leaf's ``[i]``, as the JAX step slices a pytree. Each microbatch's
gradients add into an f32 accumulator, the sum is scaled by 1/accum,
clipped by its global norm, fed to adamw, and the update is scaled by the
state's ``lr_scale`` before it lands on the params, as the JAX step does.
With one microbatch the grads stay in the param dtype and no accumulator
exists.

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
from typing import Any, Callable, Iterable, List, Tuple

import torch

from dlrover_tpu_torch.common.tree import Tree, flatten
from dlrover_tpu_torch.train.optim import make_optimizer

#: a tensor, or a tuple or list of batches
Batch = Any
LossFn = Callable[[Tree, Batch], torch.Tensor]


def batch_leaves(batch: Batch) -> List[torch.Tensor]:
    """The tensors of a batch tree, in order."""
    if isinstance(batch, torch.Tensor):
        return [batch]
    return [t for b in batch for t in batch_leaves(b)]


def microbatch(batch: Batch, i: int) -> Batch:
    """Row ``i`` of every leaf of a batch tree."""
    if isinstance(batch, torch.Tensor):
        return batch[i]
    return type(batch)(microbatch(b, i) for b in batch)


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
        """(accum_steps, micro_batch): the leading dims of every leaf of a
        batch fed to ``step``."""
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

    def step(self, state: dict, batch: Batch) -> Tuple[dict, torch.Tensor]:
        """One optimizer step over ``batch``, each leaf shaped
        (accum_steps, micro, ...). Returns the (updated in place) state and
        the mean microbatch loss as a 0-dim tensor on the params' device."""
        accum = self.accum_steps
        leads = [t.shape[0] if t.dim() else None for t in batch_leaves(batch)]
        if not leads or any(lead != accum for lead in leads):
            raise ValueError(
                f"batch leaves lead with {leads}, expected accum_steps="
                f"{accum}"
            )
        leaves = flatten(state["params"])
        tensors = [p for _, p in leaves]
        loss_sum = None
        grads = None
        for i in range(accum):
            loss = self.loss_fn(state["params"], microbatch(batch, i))
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
    def eval_step(self, state: dict, batch: Batch) -> torch.Tensor:
        """Loss of one microbatch (a tensor or a tree of tensors, one row
        of a ``step`` batch) without touching the train state."""
        return self.loss_fn(state["params"], batch)

    def evaluate(self, state: dict, batches: Iterable[Batch]) -> float:
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

