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

Runtime config, as the JAX trainer polls it: with a ``worker_ctx`` (the
worker's ``bootstrap.WorkerContext``) each step first runs
``poll_runtime_config``, which every ``poll_every_steps`` host steps (100
by default, as the JAX step polls) re-reads the agent's parallel-config
file and applies a pushed ``optimizer_learning_rate`` as ``lr_scale``
relative to the configured base lr (``apply_paral_config``; the
schedule's shape is kept, and ``lr_scale`` stays a host float, so nothing
on the step path syncs the device), then polls the goodput planner's
speculation hint (``set_speculation_hint`` records the target world and
logs it; the warm compiler that would build it ahead waits for ROADMAP
item 8).

The device timer: in a worker that preloaded the timer's hook
(``elastic_run --tpu-timer``, profiler/tpu_timer.py), a step on the card is
also timed as the program ``train_step``, the counterpart of the JAX
``train_step`` program the TPU timer sees: the hook records its own CUDA
events right after the step's start event and right before its end event,
on the same stream, with a cost of 6·params·tokens flops (token-id
batches; the definition of MFU in PERF.md), which feeds the timer's live
MFU gauge. The step's own events and the digest are unchanged.

Meshes beyond dp (fsdp, tp, zero-1), hierarchical collectives, warm
compile, remesh and the lint hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import torch

from dlrover_tpu_torch.agent.paral_config_tuner import read_paral_config
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.tree import Tree, flatten
from dlrover_tpu_torch.common.world import WorldDescriptor
from dlrover_tpu_torch.observability.digest import StepTimeDigest
from dlrover_tpu_torch.profiler import tpu_timer
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
                 loss_sums_fn: Optional[LossSumsFn] = None,
                 worker_ctx=None):
        self.loss_fn = loss_fn
        self.loss_sums_fn = loss_sums_fn
        self.tc = train_config
        #: the worker's bootstrap context: runtime config and the
        #: planner's hint are polled through it (module docstring)
        self.worker_ctx = worker_ctx
        #: host steps between two runtime-config polls of ``step``
        self.poll_every_steps = 100
        self._applied_config_version = 0
        #: the world the goodput planner's executed plan seats next
        #: (set_speculation_hint); None without a hint
        self.speculation_hint: Optional[WorldDescriptor] = None
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
        #: steps this process has run (the JAX trainer's host step)
        self._host_step = 0
        #: the device timer's C API when the process preloaded its hook
        self._step_timer = tpu_timer.step_timer()

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

    def _step_flops(self, tensors: List[torch.Tensor], batch: Batch) -> float:
        """6·params·tokens of this rank's step when ``batch`` holds token
        ids; 0 otherwise (the timer then keeps no MFU for the step)."""
        leaf = batch_leaves(batch)[0]
        if leaf.is_floating_point():
            return 0.0
        return 6.0 * sum(t.numel() for t in tensors) * leaf.numel()

    def _end_step(self, t0: float, device_start, stream, timer_token=0):
        """Account for the step just queued on ``stream`` (module
        docstring)."""
        self._host_step += 1
        sample = self._host_step > 1
        if device_start is None:
            if sample:
                self._digest.add(time.monotonic() - t0)
            return
        if timer_token:
            self._step_timer.end(timer_token, stream.cuda_stream)
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
        if self.worker_ctx is not None:
            state = self.poll_runtime_config(state, self.poll_every_steps)
        t0 = time.monotonic()
        leaves = flatten(state["params"])
        tensors = [p for _, p in leaves]
        # the params' device is where the step runs, whatever the batch's
        device_start, stream, timer_token = None, None, 0
        if tensors and tensors[0].is_cuda:
            stream = torch.cuda.current_stream(tensors[0].device)
            device_start = torch.cuda.Event(enable_timing=True)
            device_start.record(stream)
            if self._step_timer is not None:
                timer_token = self._step_timer.begin(
                    "train_step", stream.cuda_stream,
                    self._step_flops(tensors, batch))
        try:
            return self._step_body(state, batch, leaves, tensors, t0,
                                   device_start, stream, timer_token)
        except BaseException:
            if timer_token:
                # an execution left open would read as a hang
                self._step_timer.end(timer_token, stream.cuda_stream)
            raise

    def _step_body(self, state, batch, leaves, tensors, t0, device_start,
                   stream, timer_token):
        """``step`` past its start events: the microbatches, the dp
        reduce, clipping and adamw."""
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
        self._end_step(t0, device_start, stream, timer_token)
        return state, loss

    # -- runtime config and the planner's hint ------------------------------

    def _descriptor_for_world(
        self, world: int, n_slices: Optional[int] = None
    ) -> Optional[WorldDescriptor]:
        """This trainer's layout (pure dp) on ``world`` processes, or None
        when that world is inadmissible: the global batch must divide
        into ``micro_batch x world``, and a multislice world must split
        dp evenly over its slices."""
        if world <= 0:
            return None
        slices = max(1, int(n_slices)) if n_slices is not None else 1
        if world % slices:
            return None
        if self.tc.global_batch_size % (self.tc.micro_batch_size * world):
            return None
        return WorldDescriptor.from_axis_sizes(
            {"dp": world}, n_slices=slices, hier=slices > 1)

    def set_speculation_hint(self, hint, n_slices: Optional[int] = None):
        """Record the exact world the master's goodput planner intends to
        resize to next (brain/planner.py) and log it. ``hint``: a
        :class:`WorldDescriptor`, a process-world size (the caller
        converts the master's node-level hint, ``WorkerContext.
        poll_speculation_hint``), or None to clear. An inadmissible hint,
        or the world this trainer already runs, records nothing. The warm
        compiler that would build the target ahead waits for ROADMAP
        item 8."""
        if hint is None:
            self.speculation_hint = None
            return
        if isinstance(hint, WorldDescriptor):
            wd = self._descriptor_for_world(hint.world_size,
                                            n_slices=hint.n_slices)
        else:
            wd = self._descriptor_for_world(int(hint), n_slices=n_slices)
        if wd is not None and wd.world_size == self.dp:
            wd = None  # already there
        if wd is not None:
            logger.info("speculation hint armed: planner intends world %s",
                        wd.spec)
        self.speculation_hint = wd

    def apply_paral_config(self, state: dict, config: dict) -> dict:
        """Apply a master-pushed runtime config to the train state: a new
        ``optimizer_learning_rate`` becomes the update multiplier
        ``lr_scale`` relative to the configured base lr (the schedule's
        shape is kept). A host float: the step reads it without a device
        sync. The dataloader fields are ``ElasticDataLoader``'s."""
        new_lr = float(config.get("optimizer_learning_rate", 0.0) or 0.0)
        if new_lr > 0 and self.tc.learning_rate > 0 and "lr_scale" in state:
            scale = new_lr / self.tc.learning_rate
            if abs(scale - float(state["lr_scale"])) > 1e-9:
                state["lr_scale"] = scale
                logger.info("runtime lr update: base=%g -> %g (scale %.4f)",
                            self.tc.learning_rate, new_lr, scale)
        return state

    def poll_runtime_config(self, state: dict,
                            every_steps: int = 100) -> dict:
        """Cheap per-step hook: every ``every_steps`` host steps re-read
        the agent-pushed parallel-config file, apply an optimizer change
        (``apply_paral_config``), and poll the planner's speculation hint
        through the worker context. Hint failures never touch the
        training loop."""
        if self._host_step % max(1, every_steps):
            return state
        config = read_paral_config()
        version = int(config.get("optimizer_version", 0)
                      or config.get("dataloader_version", 0) or 0)
        if config and version != self._applied_config_version:
            self._applied_config_version = version
            state = self.apply_paral_config(state, config)
        if self.worker_ctx is not None:
            try:
                self.worker_ctx.poll_speculation_hint(self)
            except Exception:
                logger.exception("speculation-hint poll failed")
        return state

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

