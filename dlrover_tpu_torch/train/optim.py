"""The training optimizer with optax semantics, written by hand over the
parameter dict (port of dlrover_tpu/train/trainer.py::make_optimizer).

The JAX package chains ``optax.clip_by_global_norm(grad_clip)`` and
``optax.adamw(schedule, b1, b2, weight_decay)``. This module does the same
arithmetic in the same order, where torch's built-ins differ:

- clip: ``t`` when ``g_norm < max_norm``, else ``(t / g_norm) * max_norm``
  (``clip_grad_norm_`` adds 1e-6 to the norm);
- adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  correction at ``count + 1``, ``mu_hat / (sqrt(nu_hat) + eps)`` with
  ``eps = 1e-8`` outside the square root;
- decoupled weight decay ``+ wd * p`` on every leaf, norms included;
- learning rate ``-schedule(count)`` at the count *before* the increment,
  so the first warmup step has lr = schedule(0) = 0.

The update runs leaf by leaf and in place: grads are consumed (their
buffers are reused for the update) and params and moments change where
they lie, so no second param-sized tree is ever allocated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch
from torch.profiler import record_function

from dlrover_tpu_torch.common.tree import Tree, flatten, map_tree

Schedule = Callable[[int], float]


def _cosine_decay(init_value: float, decay_steps: int, alpha: float
                  ) -> Schedule:
    """``optax.cosine_decay_schedule(init_value, decay_steps, alpha)``."""

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def make_schedule(learning_rate: float, warmup_steps: int,
                  total_steps: int) -> Schedule:
    """``warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup+1), 0.1 lr)``; with no warmup ``cosine_decay_schedule(lr,
    max(total, 1), 0.1)``."""
    if warmup_steps <= 0:
        return _cosine_decay(learning_rate, max(total_steps, 1), 0.1)
    end_value = learning_rate * 0.1
    alpha = 0.0 if learning_rate == 0.0 else end_value / learning_rate
    decay = _cosine_decay(
        learning_rate, max(total_steps, warmup_steps + 1) - warmup_steps, alpha
    )

    def schedule(count: int) -> float:
        if count < warmup_steps:  # linear_schedule(0, lr, warmup)
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (0.0 - learning_rate) * frac + learning_rate
        return decay(count - warmup_steps)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clipping, then adamw: ``init`` builds the state,
    ``step`` applies one update in place."""

    schedule: Schedule
    max_norm: float
    b1: float
    b2: float
    weight_decay: float
    eps: float = 1e-8

    def init(self, params: Tree) -> dict:
        """Zero moments in the params' dtype, and the step count."""
        return {"count": 0, "mu": map_tree(torch.zeros_like, params),
                "nu": map_tree(torch.zeros_like, params)}

    @torch.no_grad()
    @record_function("optimizer_update")
    def step(self, params: Tree, grads: Dict[str, torch.Tensor], state: dict,
             lr_scale: float = 1.0) -> None:
        """``params += lr_scale * update(grads)``. ``grads`` maps each
        leaf's path (as ``common.tree.flatten`` names it) to its gradient,
        which this call overwrites. Runs in the ``optimizer_update``
        profiler scope."""
        leaves = flatten(params)
        mus = dict(flatten(state["mu"]))
        nus = dict(flatten(state["nu"]))
        g_list: List[torch.Tensor] = [grads[path] for path, _ in leaves]
        g_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in g_list])
        )
        keep = g_norm < self.max_norm
        # (t / g_norm) * max_norm, or t itself (t / 1 * 1) below the norm
        divisor = torch.where(keep, 1.0, g_norm)
        factor = torch.where(keep, 1.0, self.max_norm)
        count = state["count"]
        lr = self.schedule(count)
        bc1 = 1 - self.b1 ** (count + 1)
        bc2 = 1 - self.b2 ** (count + 1)
        for (path, p), g in zip(leaves, g_list):
            mu, nu = mus[path], nus[path]
            g.div_(divisor.to(g.dtype)).mul_(factor.to(g.dtype))
            mu.mul_(self.b1).add_(g * (1 - self.b1))
            nu.mul_(self.b2).add_(g.square().mul_(1 - self.b2))
            denom = torch.div(nu, bc2, out=g).sqrt_().add_(self.eps)
            update = torch.div(mu, bc1).div_(denom)
            update.add_(p * self.weight_decay).mul_(-lr)
            if lr_scale != 1.0:
                update.mul_(lr_scale)
            p.add_(update)
        state["count"] = count + 1


def make_optimizer(tc) -> AdamW:
    """The optimizer a ``TrainConfig`` asks for."""
    return AdamW(
        schedule=make_schedule(tc.learning_rate, tc.warmup_steps,
                               tc.total_steps),
        max_norm=tc.grad_clip, b1=tc.b1, b2=tc.b2,
        weight_decay=tc.weight_decay,
    )
