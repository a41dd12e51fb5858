"""ElasticTrainer (port of dlrover_tpu/train/trainer.py's step path), on
one device or data-parallel over the default process group.

One optimizer step is ``accum_steps = global_batch // (micro_batch · dp)``
microbatches, ``dp`` the process group's world size (1 without a group), as
the JAX trainer's ``_accum_for`` computes it. A batch is a tensor (token ids
for the LM families) or a tree of tensors (an ``(images, labels)`` tuple for
the CV family) whose every leaf leads with ``accum_steps``; microbatch ``i``
is every leaf's ``[i]``, as the JAX step slices a pytree. Each microbatch's
gradients add into an f32 accumulator, the sum is scaled by 1/accum,
clipped by its global norm, fed to adamw, and the update is scaled by the
state's ``lr_scale`` before it lands on the params, as the JAX step does.
With one microbatch the grads stay in the param dtype and no accumulator
exists.

Data parallelism: every process draws the same global batch,
``step_batch_shape = (accum, micro · dp)``, and rank ``r`` trains its rows
``[r·micro, (r+1)·micro)`` of each microbatch (``rows``), the contiguous
blocks the JAX batch sharding gives each data-parallel device. The JAX loss
is one token mean over the whole global microbatch, so above dp 1 the
trainer needs a ``loss_sums_fn`` (the ``(nll_sum, n_valid)`` pair of the
rank's rows): each microbatch's valid-target count is all-reduced first and
the rank differentiates its ``nll_sum`` over that global count. The
accumulated gradients and the reported loss are all-reduced with SUM, so
clipping and adamw run on equal gradients and every rank's params stay
bitwise equal. Without a process group the step is the single-device one.

Unlike the JAX step, which returns a fresh state, this one updates the
state in place to save memory: the first microbatch's f32 gradients
become the accumulator, later ones add into it, the optimizer reuses the
gradient buffers for its update, and params and adam moments change where
they lie. ``step`` returns the same state dict it was given.

The step-time digest (``step_digest``, observability/digest.py): every
step but the first adds one sample; the first, which builds the kernels
and warms the allocator, would feed the straggler detector one giant
sample per rank. The caller's step report drains it
(``bootstrap.WorkerContext.report_step``). What a sample measures:

- On the CPU the step runs synchronously, so a sample is ``step``'s wall
  seconds from its entry to its return: the step's time.
- On the card ``step`` returns once its last kernel is queued, so its
  host wall is only the host's share of the step. A sample is instead the
  device's time between two CUDA events recorded on the step's stream at
  its entry and at its end, read once the end event has passed, never by
  synchronising the step just queued: after queuing step N the trainer
  waits for step N-1's end event and then reads every pair that has
  passed (``step_digest`` reads again, without waiting, before a report
  drains it). The host so runs at most one step ahead of the card, as
  buffer donation holds the JAX host, and a sample converges to the
  device's step time, as the JAX trainer's dispatch wall does
  (dlrover_tpu/train/trainer.py's ``step``). A caller that synchronises
  after each step sees the same: the step's device time from its first
  launch to its last kernel's end.

Meshes beyond dp (fsdp, tp, zero-1), hierarchical collectives, warm
compile, remesh and the lint hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common.tree import Tree, flatten
from dlrover_tpu_torch.observability.digest import StepTimeDigest
from dlrover_tpu_torch.train import bootstrap
from dlrover_tpu_torch.train.optim import make_optimizer

#: a tensor, or a tuple or list of batches
Batch = Any
LossFn = Callable[[Tree, Batch], torch.Tensor]
#: (sum of the per-target losses, count of valid targets) of a microbatch
LossSumsFn = Callable[[Tree, Batch], Tuple[torch.Tensor, torch.Tensor]]


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


def select_rows(batch: Batch, rows: slice) -> Batch:
    """``rows`` of the second axis of every leaf of a batch tree (a view)."""
    if isinstance(batch, torch.Tensor):
        return batch[:, rows]
    return type(batch)(select_rows(b, rows) for b in batch)


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
    """Owns the optimizer and runs the accumulate-reduce-clip-adamw step."""

    def __init__(self, loss_fn: LossFn, train_config: TrainConfig,
                 loss_sums_fn: Optional[LossSumsFn] = None):
        self.loss_fn = loss_fn
        self.loss_sums_fn = loss_sums_fn
        self.tc = train_config
        self.optimizer = make_optimizer(train_config)
        #: the last step's CUDA events around the gradients' all-reduce
        #: (dp above 1 on the card), for its device time; None otherwise
        self.reduce_events: Optional[Tuple[Any, Any]] = None
        #: each step's seconds but the first's (module docstring); read
        #: through ``step_digest``
        self._digest = StepTimeDigest()
        #: on the card, each queued step's (start, end) CUDA events and
        #: whether its time is a sample, oldest first
        self._step_events: List[Tuple[Any, Any, bool]] = []
        self._steps_run = 0

    @property
    def step_digest(self) -> StepTimeDigest:
        """The step-time digest, with the device times of every queued
        step that the card has finished folded in (no wait)."""
        self._read_step_events()
        return self._digest

    def _read_step_events(self):
        """Fold the device time of each queued step whose end event has
        passed, oldest first, into the digest."""
        while self._step_events and self._step_events[0][1].query():
            start, end, sample = self._step_events.pop(0)
            if sample:
                self._digest.add(start.elapsed_time(end) / 1e3)

    def _end_step(self, t0: float, device_start, stream):
        """Account for the step just queued on ``stream`` (module
        docstring)."""
        self._steps_run += 1
        sample = self._steps_run > 1
        if device_start is None:
            if sample:
                self._digest.add(time.monotonic() - t0)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        if self._step_events:
            self._step_events[-1][1].synchronize()
        self._step_events.append((device_start, end, sample))
        self._read_step_events()

    @property
    def dp(self) -> int:
        """Data-parallel size: the default process group's world size."""
        return bootstrap.process_count()

    @property
    def accum_steps(self) -> int:
        denom = self.tc.micro_batch_size * self.dp
        if self.tc.global_batch_size % denom:
            raise ValueError(
                f"global_batch={self.tc.global_batch_size} not divisible by "
                f"micro_batch*dp={denom}"
            )
        return self.tc.global_batch_size // denom

    @property
    def step_batch_shape(self) -> Tuple[int, int]:
        """(accum_steps, micro_batch · dp): the leading dims of every leaf
        of the global batch each process draws; ``step`` takes this
        rank's ``rows`` of it."""
        return self.accum_steps, self.tc.micro_batch_size * self.dp

    @property
    def rows(self) -> slice:
        """This rank's rows of the global batch's second axis."""
        micro = self.tc.micro_batch_size
        r = bootstrap.process_index()
        return slice(r * micro, (r + 1) * micro)

    def local_rows(self, batch: Batch) -> Batch:
        """This rank's rows of a global batch (the batch itself at dp 1)."""
        return batch if self.dp == 1 else select_rows(batch, self.rows)

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

    def _microbatch_loss(self, params: Tree, mb: Batch, dp: int):
        """The loss whose gradient this rank adds for microbatch ``mb``.
        At dp 1, ``loss_fn``'s; above it, this rank's share of the global
        microbatch's token mean, so that the shares' sum over the ranks is
        the JAX loss of the whole global microbatch."""
        if dp == 1:
            return self.loss_fn(params, mb)
        if self.loss_sums_fn is None:
            raise ValueError(
                f"dp={dp} needs a loss_sums_fn: the loss is one token mean "
                "over the global microbatch")
        import torch.distributed as dist

        nll_sum, n_valid = self.loss_sums_fn(params, mb)
        n_valid = n_valid.detach().float().clone()
        dist.all_reduce(n_valid)
        return nll_sum / torch.clamp(n_valid, min=1.0)

    def step(self, state: dict, batch: Batch) -> Tuple[dict, torch.Tensor]:
        """One optimizer step over ``batch``, this rank's rows, each leaf
        shaped (accum_steps, micro, ...). Returns the (updated in place)
        state and the mean microbatch loss (of the global microbatches,
        the same on every rank) as a 0-dim tensor on the params' device."""
        t0 = time.monotonic()
        leaves = flatten(state["params"])
        tensors = [p for _, p in leaves]
        # the params' device is where the step runs, whatever the batch's
        device_start, stream = None, None
        if tensors and tensors[0].is_cuda:
            stream = torch.cuda.current_stream(tensors[0].device)
            device_start = torch.cuda.Event(enable_timing=True)
            device_start.record(stream)
        accum = self.accum_steps
        dp = self.dp
        micro = self.tc.micro_batch_size
        leaves_in = batch_leaves(batch)
        leads = [t.shape[0] if t.dim() else None for t in leaves_in]
        if not leads or any(lead != accum for lead in leads):
            raise ValueError(
                f"batch leaves lead with {leads}, expected accum_steps="
                f"{accum}"
            )
        if dp > 1 and any(t.dim() < 2 or t.shape[1] != micro
                          for t in leaves_in):
            raise ValueError(
                f"batch leaves are {[tuple(t.shape) for t in leaves_in]}; at "
                f"dp={dp} each takes this rank's micro_batch={micro} rows "
                "(ElasticTrainer.local_rows)"
            )
        loss_sum = None
        grads = None
        for i in range(accum):
            loss = self._microbatch_loss(state["params"],
                                         microbatch(batch, i), dp)
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
        if dp > 1:
            import torch.distributed as dist

            # one collective a leaf: a flat buffer would cost a copy of
            # the first microbatch's grads, which measured slower (PERF.md)
            cuda = grads[0].is_cuda
            if cuda:
                self.reduce_events = (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))
                self.reduce_events[0].record()
            for acc in grads:
                dist.all_reduce(acc)
            if cuda:
                self.reduce_events[1].record()
            dist.all_reduce(loss_sum)
        if accum > 1:
            scale = 1.0 / accum
            for acc in grads:
                acc.mul_(scale)
        self.optimizer.step(
            state["params"], {path: g for (path, _), g in zip(leaves, grads)},
            state["opt"], lr_scale=state["lr_scale"],
        )
        state["step"] += 1
        loss = loss_sum * (1.0 / accum)
        self._end_step(t0, device_start, stream)
        return state, loss

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

