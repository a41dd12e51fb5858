"""ElasticTrainer (port of dlrover_tpu/train/trainer.py's step path), on
one device, data-parallel over the default process group, or on a
``DeviceMesh`` of dp, fsdp, sp and tp.

One optimizer step is ``accum_steps = global_batch // (micro_batch · dp)``
microbatches, ``dp`` the data-parallel size: the mesh's batch axes (dp ·
fsdp · ep, ``parallel.BATCH_AXES``), else the process group's world size
(1 without a group), as the JAX trainer's ``_accum_for`` computes it. A
batch is a tensor (token ids for the LM families) or a tree of tensors
(an ``(images, labels)`` tuple for the CV family) whose every leaf leads
with ``accum_steps``; microbatch ``i`` is every leaf's ``[i]``, as the
JAX step slices a pytree. Each microbatch's
gradients add into an f32 accumulator, the sum is scaled by 1/accum,
clipped by its global norm, fed to adamw, and the update is scaled by the
state's ``lr_scale`` before it lands on the params, as the JAX step does.
With one microbatch the grads stay in the param dtype and no accumulator
exists.

Data parallelism: every process draws the same global batch,
``step_batch_shape = (accum, micro · dp)``, and the rank of data index
``r`` trains its rows ``[r·micro, (r+1)·micro)`` of each microbatch
(``rows``), the contiguous blocks the JAX batch sharding gives each
data-parallel device (``r`` is the rank's index over the mesh's batch
axes, dp major, else its process index). The JAX loss
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
speculation hint (``set_speculation_hint`` refits the mesh to the target
world, records it and logs it; the warm compiler that would build it
ahead, train/warm_compile.py, is not ported yet).

The device timer: in a worker that preloaded the timer's hook
(``elastic_run --tpu-timer``, profiler/tpu_timer.py), a step on the card is
also timed as the program ``train_step``, the counterpart of the JAX
``train_step`` program the TPU timer sees: the hook records its own CUDA
events right after the step's start event and right before its end event,
on the same stream, with a cost of this rank's share of 6·params·tokens
flops (token-id batches; the definition of MFU in PERF.md): the tokens of
its rows, divided by tp and sp, since a tp rank does 1/tp of each row's
work and an sp rank sees 1/sp of its positions (an fsdp rank gathers the
whole model for its own rows). It feeds the timer's live MFU gauge. The
step's own events and the digest are unchanged.

ZeRO-1 (train/zero1.py): with ``TrainConfig.zero1`` or
``DLROVER_TPU_ZERO1`` at dp above 1 (the ``mesh`` given, else
``bootstrap.worker_mesh``'s pure-dp mesh on the params' device type),
adam's moments hold only this rank's dp shard, each accumulated gradient
leaf is reduce-scattered over the mesh's dp group into that shard (a leaf
with no divisible dim is all-reduced whole), the optimizer updates this
rank's shard of every param, and the params are all-gathered in place
over dp. Beside fsdp, sp or tp (``"gspmd"``) all of this runs on the
shard each rank holds. The loss's valid-target count and the reported
loss are all-reduced as in the replicated step. ``zero1_mode`` says which
update runs (``"off"`` at dp 1); a zero-1 request on a mesh with ep or pp
above 1 raises (``zero1.mode_for``).

On the card the step leaves CUDA events around its collectives and its
update, read by callers that time them: ``reduce_events`` around the
gradients' all-reduces or reduce-scatters, ``update_events`` around the
optimizer update, ``gather_events`` around zero-1's param all-gathers
(None where the step has no such part).

FSDP (ZeRO-3): on a mesh with fsdp above 1 (``mesh`` given: the caller
builds it, ``bootstrap.worker_mesh(device_type, MeshConfig(fsdp=N))``,
and places the params on it, models/llama.py) every param is a DTensor
and each rank differentiates its local shards: the model gathers the
weights and its gathers' backward reduce-scatters each gradient over
fsdp, so a sharded leaf's gradient arrives as this rank's shard of the
fsdp sum. It is accumulated as a shard, then all-reduced over dp (under
zero-1, ``"gspmd"``, reduce-scattered over dp into the moments' shard); a
leaf replicated over fsdp (the norms) is all-reduced over fsdp first. The
global norm sums the pieces' squares over the axes that split them
(train/optim.py's ``NormPlan``). ``reduce_events`` then spans only these
trailing collectives: the fsdp reduce-scatters run in the backward.

Tensor parallelism (tp above 1 on the ``mesh``; models/llama.py): tp is
not a batch axis, so the ranks of a tp group train the same rows and
every rank computes the same loss. Each rank differentiates its tp
shards; the model's f/g regions make a tp-replicated leaf's gradient (the
norms) the total on every tp rank, so it gets no tp reduction, as the
JAX package's loss axes leave tp out. Every data-parallel collective of
the step (the gradients' reduction, the valid-target count, the reported
loss) runs over the batch axes' group (``parallel.axes_group``: the
mesh's dp group beside tp alone, a group of its own when two batch axes
are above 1), never the whole world, which would count each row tp
times. The global norm sums a tp-split leaf's pieces over tp.

Sequence parallelism (sp above 1; models/llama.py): sp is not a batch
axis either, so the ranks of an sp group train the same rows (``rows``
slices over the batch axes only) and each hands the whole rows to the
loss, which runs this rank's chunk of ``s/sp`` positions. So every sum
the JAX package takes over its loss axes (``_PP_LOSS_AXES``) runs over the
batch axes and sp here: the valid-target count, the reported loss, and
every gradient, the leaves that fsdp's gathers already reduce-scattered
over fsdp and the tp-replicated norms included. The group is
``parallel.axes_group(mesh, BATCH_AXES + (SP,))``. After the sum the
gradients are equal over sp, so the global norm adds no sp axis. ep and
pp above 1 raise (later slices).

Hierarchical collectives, warm compile, remesh and the lint hooks are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from dlrover_tpu_torch.agent.paral_config_tuner import read_paral_config
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.tree import Tree, flatten
from dlrover_tpu_torch.common.world import WorldDescriptor
from dlrover_tpu_torch.observability.digest import StepTimeDigest
from dlrover_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    DP,
    FSDP,
    SP,
    TP,
    MeshConfig,
    axes_group,
    axis_sizes,
    check_ported_axes,
    data_parallel,
    remesh,
)
from dlrover_tpu_torch.parallel.sharding import entry_axes, local_of, spec_of
from dlrover_tpu_torch.profiler import tpu_timer
from dlrover_tpu_torch.train import bootstrap, zero1
from dlrover_tpu_torch.train.optim import NormPlan, make_optimizer

#: a tensor, or a tuple or list of batches
Batch = Any
LossFn = Callable[[Tree, Batch], torch.Tensor]
#: (sum of the per-target losses, count of valid targets) of a microbatch
LossSumsFn = Callable[[Tree, Batch], Tuple[torch.Tensor, torch.Tensor]]


def _record(cuda: bool, events=None):
    """On the card, record a new (start, end) pair's start on the current
    stream and return the pair, or record ``events``' end; None on the
    CPU."""
    if not cuda:
        return None
    if events is None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    else:
        events[1].record()
    return events


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


def _split_axes(p) -> Tuple[str, ...]:
    """The param-splitting axes, fsdp and tp, that a param's spec names
    above size 1 (a DTensor's; ``()`` for a whole tensor), in mesh
    order."""
    if not hasattr(p, "to_local"):
        return ()
    named = {a for e in spec_of(p) for a in entry_axes(e)}
    return tuple(a for a in (FSDP, TP) if a in named)


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
    # ZeRO-1 weight-update sharding across dp (train/zero1.py); the
    # DLROVER_TPU_ZERO1 flag overrides it in both directions. No-op at dp 1.
    zero1: bool = False


class ElasticTrainer:
    """Owns the optimizer and runs the accumulate-reduce-clip-adamw step."""

    def __init__(self, loss_fn: LossFn, train_config: TrainConfig,
                 loss_sums_fn: Optional[LossSumsFn] = None,
                 worker_ctx=None, mesh=None):
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
        #: the last step's CUDA events (module docstring); None otherwise
        self.reduce_events: Optional[Tuple[Any, Any]] = None
        self.update_events: Optional[Tuple[Any, Any]] = None
        self.gather_events: Optional[Tuple[Any, Any]] = None
        #: bytes of the last step's accumulated gradients as this rank
        #: holds them before the data-parallel reduction
        self.grad_bytes = 0
        #: the DeviceMesh the step runs on (None: a world of one, or the
        #: replicated dp step over the default process group)
        self.mesh = mesh
        #: "off", "scatter" or "gspmd" (train/zero1.py), set by
        #: ``init_state``
        self.zero1_mode = "off"
        self._zero1: Optional[zero1.Layout] = None
        #: the mesh's fsdp and tp sizes (1: params whole), and which of
        #: the two split each leaf, set by ``init_state``
        self.fsdp = 1
        self.tp = 1
        self._split: Dict[str, Tuple[str, ...]] = {}
        #: the process group of the batch axes and sp, over which the
        #: loss's sums run (None: the default group)
        self._loss_group = None
        #: leaf path -> the process group its accumulated gradient is
        #: all-reduced over before zero-1's scatter (None: the default
        #: group); a leaf absent needs no all-reduce
        self._grad_groups: Dict[str, Any] = {}
        #: where the gradients are pieces, for the global norm (None: whole)
        self._norm_plan: Optional[NormPlan] = None
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
        """This rank's share of 6·params·tokens when ``batch`` (its rows)
        holds token ids: the whole model's params (a DTensor's ``numel``
        is the whole leaf's) over the rows' tokens, divided by tp and sp
        (module docstring); 0 otherwise (the timer then keeps no MFU for
        the step)."""
        leaf = batch_leaves(batch)[0]
        if leaf.is_floating_point():
            return 0.0
        cfg = self.mesh_config
        return (6.0 * sum(t.numel() for t in tensors) * leaf.numel()
                / (cfg.tp * cfg.sp))

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
        """Data-parallel size: the mesh's batch axes (dp · fsdp · ep), else
        the default process group's world size."""
        if self.mesh is None:
            return bootstrap.process_count()
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes.get(a, 1) for a in BATCH_AXES)

    @property
    def loss_ranks(self) -> int:
        """The ranks the loss's sums and the gradients are summed over:
        the batch axes' size times sp."""
        return self.dp * self.mesh_config.sp

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
        r = (bootstrap.process_index() if self.mesh is None
             else data_parallel(self.mesh)[0])
        return slice(r * micro, (r + 1) * micro)

    def local_rows(self, batch: Batch) -> Batch:
        """This rank's rows of a global batch (the batch itself at dp 1)."""
        return batch if self.dp == 1 else select_rows(batch, self.rows)

    def init_state(self, params: Tree) -> dict:
        """Train state around ``params``, whose leaves become the leaves
        that autograd differentiates (``requires_grad``). On an fsdp or tp
        mesh every leaf must be a DTensor on it (the model's placement)."""
        named = flatten(params)
        for _, p in named:
            p.requires_grad_(True)
        if zero1.enabled(self.tc) and self.mesh is None and self.dp > 1:
            # the worker's pure-dp mesh over the process group
            self.mesh = bootstrap.worker_mesh(
                local_of(named[0][1]).device.type)
        self.zero1_mode = zero1.mode_for(self.mesh, self.tc)
        if self.mesh is not None:
            check_ported_axes(self.mesh)
        sizes = axis_sizes(self.mesh) if self.mesh is not None else {}
        self.fsdp, self.tp = sizes.get(FSDP, 1), sizes.get(TP, 1)
        if self.fsdp > 1 or self.tp > 1:
            loose = [path for path, p in named if not hasattr(p, "to_local")]
            if loose:
                raise ValueError(
                    f"fsdp={self.fsdp}, tp={self.tp}: params {loose[:3]} are "
                    "not DTensors on the mesh (place them per the model's "
                    "specs)")
        self._split = {path: _split_axes(p) for path, p in named}
        if self.mesh is not None and self.loss_ranks > 1:
            self._loss_group = axes_group(self.mesh, BATCH_AXES + (SP,))
        self._zero1 = (zero1.Layout.build(self.mesh, named)
                       if self.zero1_mode != "off" else None)
        self._grad_groups = self._plan_grad_sums(named, sizes)
        self._norm_plan = self._plan_norm(named)
        return {
            "params": params,
            "opt": self.optimizer.init(params, self._zero1),
            "step": 0,
            # runtime lr multiplier applied to the optimizer's updates
            "lr_scale": 1.0,
        }

    def _plan_norm(self, named) -> Optional[NormPlan]:
        """Over which axes each leaf's reduced gradient is split: dp where
        zero-1 scatters it, fsdp and tp where the param is a shard over
        them; None when every gradient is whole. Each set's process group
        is built here, in one order on every rank."""
        if self._zero1 is None and self.fsdp == 1 and self.tp == 1:
            return None
        axes = {}
        for path, _ in named:
            a = ()
            if self._zero1 is not None and self._zero1.dim(path) is not None:
                a += (DP,)
            axes[path] = a + self._split[path]
        plan = NormPlan(mesh=self.mesh, axes=axes)
        for a in sorted(set(axes.values())):
            if a:
                plan.group(a)
        return plan

    def _plan_grad_sums(self, named, sizes) -> Dict[str, Any]:
        """Each leaf's all-reduce before the optimizer: over the batch axes
        and sp, less fsdp where the model's gather already reduce-scattered
        the leaf over fsdp and less dp where zero-1 reduce-scatters it
        (``Layout.reduce_scatter``). Without a mesh, over the default group
        at dp above 1. Each set's process group is built here, in one order
        on every rank."""
        if self.mesh is None:
            return {path: None for path, _ in named} if self.dp > 1 else {}
        live = [a for a in AXIS_ORDER
                if a in BATCH_AXES + (SP,) and sizes.get(a, 1) > 1]
        out = {}
        for path, _ in named:
            axes = tuple(
                a for a in live
                if not (a == FSDP and FSDP in self._split[path])
                and not (a == DP and self._zero1 is not None))
            if axes:
                out[path] = axes
        groups = {axes: axes_group(self.mesh, axes)
                  for axes in sorted(set(out.values()))}
        return {path: groups[axes] for path, axes in out.items()}

    def _reduce_grad(self, path: str, g: torch.Tensor) -> torch.Tensor:
        """The data-parallel sum of one accumulated gradient (what this
        rank holds of it), laid out as the optimizer takes it (module
        docstring)."""
        import torch.distributed as dist

        if path in self._grad_groups:
            # NCCL takes a dense tensor: the gradient of an fsdp gather
            # along dim 1 (the embedding's) is a strided view
            g = g.contiguous()
            dist.all_reduce(g, group=self._grad_groups[path])
        if self._zero1 is not None:
            return self._zero1.reduce_scatter(path, g)
        return g

    def _microbatch_loss(self, params: Tree, mb: Batch, ranks: int):
        """The loss whose gradient this rank adds for microbatch ``mb``.
        Over one rank, ``loss_fn``'s; over more (``loss_ranks``: the batch
        axes and sp), this rank's share of the global microbatch's token
        mean, so that the shares' sum over the ranks is the JAX loss of
        the whole global microbatch."""
        if ranks == 1:
            return self.loss_fn(params, mb)
        if self.loss_sums_fn is None:
            raise ValueError(
                f"a step over {ranks} ranks of rows and sequence chunks "
                "needs a loss_sums_fn: the loss is one token mean over the "
                "global microbatch")
        import torch.distributed as dist

        nll_sum, n_valid = self.loss_sums_fn(params, mb)
        n_valid = n_valid.detach().float().clone()
        dist.all_reduce(n_valid, group=self._loss_group)
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
        if tensors and local_of(tensors[0]).is_cuda:
            stream = torch.cuda.current_stream(local_of(tensors[0]).device)
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
        ranks = self.loss_ranks
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
                                         microbatch(batch, i), ranks)
            # a DTensor param's gradient: this rank's shard of it
            g = [local_of(t) for t in torch.autograd.grad(loss, tensors)]
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
        cuda = grads[0].is_cuda
        self.grad_bytes = sum(g.nbytes for g in grads)
        z1 = self._zero1
        if ranks > 1:
            import torch.distributed as dist

            # one collective a leaf: a flat buffer would cost a copy of
            # the first microbatch's grads, which measured slower
            # (PERF.md); under zero-1 the leaf is freed as its shard arrives
            self.reduce_events = _record(cuda)
            for i, (path, _) in enumerate(leaves):
                grads[i] = self._reduce_grad(path, grads[i])
            _record(cuda, self.reduce_events)
            dist.all_reduce(loss_sum, group=self._loss_group)
        if accum > 1:
            scale = 1.0 / accum
            for acc in grads:
                acc.mul_(scale)
        self.update_events = _record(cuda)
        self.optimizer.step(
            state["params"], {path: g for (path, _), g in zip(leaves, grads)},
            state["opt"], lr_scale=state["lr_scale"], zero1=z1,
            norm_plan=self._norm_plan,
        )
        _record(cuda, self.update_events)
        if z1 is not None:
            del grads
            self.gather_events = _record(cuda)
            for path, p in leaves:
                z1.all_gather_(path, p)
            _record(cuda, self.gather_events)
        state["step"] += 1
        loss = loss_sum * (1.0 / accum)
        self._end_step(t0, device_start, stream, timer_token)
        return state, loss

    def world_descriptor(self) -> WorldDescriptor:
        """The world this trainer runs: its mesh's axes (pure dp over the
        process group without one), ``+zero1`` when the zero-1 update runs
        (``zero1_mode``), so a seated spec says what runs."""
        return WorldDescriptor.from_axis_sizes(
            self.mesh_config.shape(), zero1=self.zero1_mode != "off")

    # -- runtime config and the planner's hint ------------------------------

    @property
    def mesh_config(self) -> MeshConfig:
        """The resolved mesh config this trainer runs: its mesh's axes,
        pure dp over the process group without one."""
        if self.mesh is None:
            return MeshConfig(dp=self.dp)
        sizes = axis_sizes(self.mesh)
        return MeshConfig(**{a: sizes.get(a, 1) for a in AXIS_ORDER})

    def _descriptor_for_world(
        self, world: int, n_slices: Optional[int] = None
    ) -> Optional[WorldDescriptor]:
        """This trainer's mesh config refitted onto ``world`` processes
        (``parallel.remesh``: the model axes kept, the data axes absorbing
        the rest; without a mesh, the replicated step, pure dp at any
        world) and described, or None when that world is inadmissible:
        the model axes do not divide it, the global batch does not divide
        into ``micro_batch x`` its data size, or a multislice world does
        not split it evenly over its slices. The JAX trainer's filters."""
        if world <= 0:
            return None
        slices = max(1, int(n_slices)) if n_slices is not None else 1
        if slices > 1 and world % slices:
            return None
        config = self.mesh_config if self.mesh is not None else MeshConfig()
        try:
            resolved = remesh(config, world).resolve(world)
        except ValueError:
            return None
        dp = resolved.data_parallel_size
        if self.tc.global_batch_size % (self.tc.micro_batch_size * dp):
            return None
        if slices > 1 and dp % slices:
            return None
        try:
            return WorldDescriptor.from_axis_sizes(
                resolved.shape(), n_slices=slices, hier=slices > 1,
                zero1=resolved.dp > 1 and zero1.enabled(self.tc))
        except ValueError:
            return None

    def set_speculation_hint(self, hint, n_slices: Optional[int] = None):
        """Record the exact world the master's goodput planner intends to
        resize to next (brain/planner.py) and log it. ``hint``: a
        :class:`WorldDescriptor`, a process-world size (the caller
        converts the master's node-level hint, ``WorkerContext.
        poll_speculation_hint``), or None to clear. An inadmissible hint,
        or the world size this trainer already runs, records nothing. The
        warm compiler that would build the target ahead
        (train/warm_compile.py) is not ported yet."""
        if hint is None:
            self.speculation_hint = None
            return
        if isinstance(hint, WorldDescriptor):
            wd = self._descriptor_for_world(hint.world_size,
                                            n_slices=hint.n_slices)
        else:
            wd = self._descriptor_for_world(int(hint), n_slices=n_slices)
        if wd is not None and wd.world_size == math.prod(
                self.mesh_config.shape().values()):
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

