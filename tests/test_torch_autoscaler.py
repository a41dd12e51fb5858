"""The port's auto-scaler (master/node/job_auto_scaler.py), optimizer
(master/resource/optimizer.py), scaler (master/scaler/base.py) and
strategy generator (master/hyperparams.py), held to the JAX package's on
the CPU.

Each case of the JAX package's ``tests/test_autoscaler.py`` runs one
script through the JAX classes and through the port's, each on its own
package's job context and speed monitor with one virtual clock: the
``ResourcePlan``\\ s and ``ScalePlan``\\ s must be equal, and so must every
node's pushed parallel config, the registry's live nodes and the
strategy suggestions. Then the parallel-config chain end to end: both
auto-scalers push an ``optimizer_learning_rate``, each package's servicer
answers the ``ParallelConfigRequest`` and its ``ParalConfigTuner`` writes
the file, and the port trainer's ``poll_runtime_config`` sets ``lr_scale``
to the JAX trainer's; the step after it matches the JAX trainer's at the
trainer tests' tolerance.
"""

import dataclasses
import json
import types

import pytest

from dlrover_tpu.brain import planner as jplanner
from dlrover_tpu.common import constants as jconst
from dlrover_tpu.common import node as jnode
from dlrover_tpu.master import hyperparams as jhyper
from dlrover_tpu.master import job_container as jcontainer
from dlrover_tpu.master.monitor import speed_monitor as jsm
from dlrover_tpu.master.node import job_auto_scaler as jauto
from dlrover_tpu.master.resource import optimizer as jopt
from dlrover_tpu.master.resource import plan as jplan
from dlrover_tpu.master.scaler import base as jscaler
from dlrover_tpu_torch.brain import planner as pplanner
from dlrover_tpu_torch.common import constants as pconst
from dlrover_tpu_torch.common import node as pnode
from dlrover_tpu_torch.common.global_context import MasterConfigContext
from dlrover_tpu_torch.master import hyperparams as phyper
from dlrover_tpu_torch.master.monitor import speed_monitor as psm
from dlrover_tpu_torch.master.node import job_auto_scaler as pauto
from dlrover_tpu_torch.master.node.job_context import JobContext
from dlrover_tpu_torch.master.resource import optimizer as popt
from dlrover_tpu_torch.master.resource import plan as pplan
from dlrover_tpu_torch.master.scaler import base as pscaler

WORKER = pconst.NodeType.WORKER
assert WORKER == jconst.NodeType.WORKER


class Pkg:
    """One package's classes, a fresh job context and master config."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.container = jcontainer.JobContainer.fresh()
            self.ctx = self.container.job_context
            self.config = self.container.config
            self.const, self.node, self.opt, self.plan = (
                jconst, jnode, jopt, jplan)
            self.scaler, self.auto, self.hyper, self.sm = (
                jscaler, jauto, jhyper, jsm)
            self.planner = jplanner
        else:
            self.ctx = JobContext()
            self.config = MasterConfigContext()
            self.const, self.node, self.opt, self.plan = (
                pconst, pnode, popt, pplan)
            self.scaler, self.auto, self.hyper, self.sm = (
                pscaler, pauto, phyper, psm)
            self.planner = pplanner

    def add_workers(self, n, status=None):
        for i in range(n):
            self.ctx.update_node(self.node.Node(
                WORKER, i, status=status or self.const.NodeStatus.RUNNING))
        return self.ctx

    def local_scaler(self):
        return self.scaler.LocalScaler(job_context=self.ctx)

    def autoscaler(self, optimizer, scaler, **kw):
        return self.auto.JobAutoScaler(optimizer, scaler, job_context=self.ctx,
                                       config=self.config, **kw)


@pytest.fixture
def pkgs():
    out = [Pkg("jax"), Pkg("port")]
    yield out
    jcontainer.reset()


def _norm(x):
    """Package-neutral form of plans, nodes and suggestions."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (jnode.Node, pnode.Node)):
        return {"type": x.type, "id": x.id, "status": x.status,
                "released": x.is_released, "paral_config": x.paral_config}
    if isinstance(x, dict):
        return {str(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _registry(pkg):
    nodes = sorted(pkg.ctx.workers().values(), key=lambda n: n.id)
    return [_norm(n) for n in nodes] + [
        sorted(n.id for n in pkg.ctx.alive_nodes(WORKER))]


def both(pkgs, fn):
    """``fn(pkg)`` for the JAX package and the port: equal results
    (normalised) and registries; returns the port's result."""
    a, b = (_norm(fn(p)) for p in pkgs)
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)
    assert _registry(pkgs[0]) == _registry(pkgs[1])
    return b


# -- the JAX package's cases -----------------------------------------------------


def case_create_plan_rounds_to_node_unit(pkgs):
    plan = both(pkgs, lambda p: p.opt.LocalOptimizer(
        min_workers=2, max_workers=10, node_unit=4).generate_opt_plan(
        p.opt.JobOptStage.CREATE, p.opt.WorkerStats()))
    assert plan["node_group_resources"][WORKER]["count"] == 8


def case_sample_plan_sizes_from_usage(pkgs):
    plan = both(pkgs, lambda p: p.opt.LocalOptimizer(
        min_workers=1, max_workers=4).generate_opt_plan(
        p.opt.JobOptStage.SAMPLE, p.opt.WorkerStats(
            cpu_percents=[50, 80], memory_mbs=[1000, 2000], worker_num=4)))
    group = plan["node_group_resources"][WORKER]
    assert group["node_resource"]["memory_mb"] == 3000 and group["count"] == 4


@pytest.mark.parametrize("fast", [11.0, 19.0, 14.0])
def case_running_plan_follows_the_knee(pkgs, fast):
    def run(p):
        opt = p.opt.LocalOptimizer(min_workers=2, max_workers=16,
                                   node_unit=2)
        for _ in range(3):
            opt.observe_speed(4, 10.0)
            opt.observe_speed(8, fast)
        return opt.generate_opt_plan(p.opt.JobOptStage.RUNNING,
                                     p.opt.WorkerStats(worker_num=8))

    plan = both(pkgs, run)
    if fast == 11.0:
        assert plan["node_group_resources"][WORKER]["count"] == 4
        assert "shrink" in plan["comment"]
    elif fast == 19.0:
        assert plan["node_group_resources"][WORKER]["count"] == 10
        assert "grow" in plan["comment"]
    else:
        assert plan["node_group_resources"] == {}


def case_running_plan_one_world_grows_when_busy(pkgs):
    def run(p):
        opt = p.opt.LocalOptimizer(min_workers=2, max_workers=16,
                                   node_unit=2)
        opt.observe_speed(8, 10.0)
        opt.observe_speed(8, 10.5)
        return [opt.generate_opt_plan(p.opt.JobOptStage.RUNNING,
                                      p.opt.WorkerStats(worker_num=8,
                                                        duty_cycles=d))
                for d in ([0.9], [0.2], [])]

    plans = both(pkgs, run)
    assert plans[0]["node_group_resources"][WORKER]["count"] == 10
    assert plans[1]["node_group_resources"] == {}


def case_oom_recovery_device_vs_host(pkgs):
    def run(p):
        opt = p.opt.LocalOptimizer(host_memory_mb=4096)
        return [opt.generate_oom_recovery_plan(
            ["worker-0"], p.opt.JobOptStage.RUNNING, host)
            for host in (False, True, True)]

    dev, host, again = both(pkgs, run)
    assert dev["paral_config"]["micro_batch_scale"] == 0.5
    assert dev["paral_config"]["grad_accum_scale"] == 2.0
    assert host["node_resources"]["worker-0"]["memory_mb"] == 8192
    assert again["node_resources"]["worker-0"]["memory_mb"] == 16384


def case_local_scaler_converges_count(pkgs):
    def run(p):
        p.add_workers(4)
        scaler = p.local_scaler()
        out = []
        for count in (2, 3, 3, 5, 1):
            plan = p.plan.ScalePlan()
            plan.node_group_resources[WORKER] = p.node.NodeGroupResource(
                count=count)
            scaler.scale(plan)
            out.append(sorted(n.id for n in p.ctx.alive_nodes(WORKER)))
        scaler.scale(p.plan.ScalePlan())  # empty: not recorded
        out.append(len(scaler.executed_plans))
        return out

    out = both(pkgs, run)
    assert [len(x) for x in out[:5]] == [2, 3, 3, 5, 1] and out[5] == 5


def case_shed_victims_takes_the_highest_ranks(pkgs):
    def run(p):
        nodes = [p.node.Node(WORKER, i, rank_index=r)
                 for i, r in enumerate([3, 0, 5, 1])]
        return [n.id for n in p.scaler.shed_victims(nodes, 2)]

    assert both(pkgs, run) == [2, 0]


def case_autoscaler_cycle_and_oom_hook(pkgs):
    def run(p):
        p.add_workers(4)
        clock = [1000.0]
        sm = p.sm.SpeedMonitor(clock=lambda: clock[0])
        sm.collect_global_step(100, 990.0)
        sm.collect_global_step(200, 1000.0)
        auto = p.autoscaler(
            p.opt.LocalOptimizer(min_workers=2, max_workers=8, node_unit=2),
            p.local_scaler(), speed_monitor=sm, interval_secs=3600,
            clock=lambda: clock[0])
        plans = [auto.optimize_once()]
        node = p.ctx.get_node(WORKER, 1)
        node.exit_reason = p.const.NodeExitReason.OOM
        auto.handle_node_failure(WORKER, 1)
        # a non-OOM failure and an unknown node change nothing
        auto.handle_node_failure(WORKER, 2)
        auto.handle_node_failure(WORKER, 99)
        node = p.ctx.get_node(WORKER, 3)
        node.exit_reason = p.const.NodeExitReason.OOM
        node.reported_status = "host oom"
        auto.handle_node_failure(WORKER, 3)
        plans.append(auto.optimize_once())
        return plans

    first, second = both(pkgs, run)
    # the second cycle sees one busy world size and grows it by a unit
    assert second["node_group_resources"][WORKER]["count"] == 6
    for nid in range(4):
        cfg = pkgs[1].ctx.get_node(WORKER, nid).paral_config
        assert cfg["micro_batch_scale"] == 0.5
        assert cfg["dataloader_version"] == 1


def case_strategy_generator(pkgs):
    s = both(pkgs, lambda p: p.hyper.SimpleStrategyGenerator(
        hbm_per_chip_gb=95, chips_per_host=4).generate_opt_strategy(
        global_batch_size=512, world_hosts=4))
    assert s["micro_batch_size"] * 4 * s["grad_accum_steps"] >= 512
    assert s["learning_rate"] > 3e-4
    cfg = both(pkgs, lambda p: p.hyper.StrategySuggestion(
        **s).to_paral_config())
    assert cfg["grad_accum_steps"] == s["grad_accum_steps"]


def case_activation_memory_model_and_initial_cap(pkgs):
    def run(p):
        full = p.hyper.ModelProfile(seq_len=2048, hidden_dim=4096,
                                    n_layers=32, n_heads=32, remat=False)
        remat = dataclasses.replace(full, remat=True)
        gen = p.hyper.SimpleStrategyGenerator(hbm_per_chip_gb=16,
                                              chips_per_host=4)
        return [p.hyper.activation_bytes_per_sample(full),
                p.hyper.activation_bytes_per_sample(remat),
                p.hyper.activation_bytes_per_sample(p.hyper.ModelProfile()),
                gen.generate_opt_strategy(global_batch_size=4096,
                                          world_hosts=2, model=full),
                gen.generate_opt_strategy(global_batch_size=64,
                                          world_hosts=1, host_cpus=16)]

    full, remat, none, s, s2 = both(pkgs, run)
    assert full > remat > 0 and full / remat > 5 and none == 0.0
    assert s["micro_batch_size"] * 2 * s["grad_accum_steps"] >= 4096
    assert s["micro_batch_size"] <= max(1, int(16e9 * 0.25 / full)) * 4


def case_refine_strategy_accum_shift_preserves_global_batch(pkgs):
    current = {"dataloader_batch_size": 8, "optimizer_learning_rate": 1e-3,
               "optimizer_weight_decay": 0.1, "grad_accum_steps": 4,
               "dataloader_num_workers": 4}

    def run(p):
        gen = p.hyper.SimpleStrategyGenerator(host_memory_floor_mb=2400)
        mp = p.hyper.ModelProfile(seq_len=128, hidden_dim=256, n_layers=4,
                                  n_heads=4)
        return [gen.refine_strategy(current, mp, 10_000, 64_000),
                gen.refine_strategy(current, mp, 63_000, 64_000),
                gen.refine_strategy({**current, "grad_accum_steps": 3}, mp,
                                    10_000, 64_000),
                gen.refine_strategy(current, p.hyper.ModelProfile(), 0,
                                    64_000)]

    s, floor, odd, unknown = both(pkgs, run)
    assert s["micro_batch_size"] == 16 and s["grad_accum_steps"] == 2
    assert s["learning_rate"] == pytest.approx(1e-3)
    assert s["weight_decay"] == pytest.approx(0.1)
    assert floor is None and odd is None and unknown is None


def case_refine_strategy_global_growth_couples_lr_and_respects_hbm(pkgs):
    current = {"dataloader_batch_size": 8, "optimizer_learning_rate": 1e-3,
               "optimizer_weight_decay": 0.1, "grad_accum_steps": 1}

    def run(p):
        mp = p.hyper.ModelProfile(seq_len=128, hidden_dim=256, n_layers=4,
                                  n_heads=4)
        gen = p.hyper.SimpleStrategyGenerator(
            hbm_per_chip_gb=95, chips_per_host=4, host_memory_floor_mb=2400)
        act = p.hyper.activation_bytes_per_sample(mp)
        small = p.hyper.SimpleStrategyGenerator(
            hbm_per_chip_gb=4 * act / 0.25 / 1e9 * 0.9, chips_per_host=4)
        return [gen.refine_strategy(current, mp, 10_000, 64_000),
                small.refine_strategy(current, mp, 10_000, 64_000)]

    s, capped = both(pkgs, run)
    assert s["micro_batch_size"] == 16 and s["grad_accum_steps"] == 1
    assert s["learning_rate"] == pytest.approx(1e-3 * 2 ** 0.5)
    assert s["weight_decay"] == pytest.approx(0.1 * 2 ** 0.5)
    assert capped is None


def _collector():
    """The model report the JAX servicer keeps in its metric collector
    (the port's collector comes with the k8s master): what
    ``maybe_refine_hyperparams`` reads."""
    metrics = types.SimpleNamespace(
        model_params=10_000_000,
        model_profile={"batch_size": 8, "seq_len": 128, "hidden_dim": 256,
                       "n_layers": 4, "n_heads": 4, "remat": True})
    return types.SimpleNamespace(metrics=metrics)


class _FakeScaler:
    def __init__(self):
        self.plans = []

    def scale(self, plan):
        self.plans.append(plan)

    def cordon(self, host):
        return False


def case_autoscaler_refines_hyperparams_from_model_report(pkgs):
    def run(p):
        for i in range(2):
            node = p.node.Node(WORKER, i, status=p.const.NodeStatus.RUNNING)
            node.config_resource.memory_mb = 64_000
            node.used_resource.memory_mb = 10_000
            node.paral_config = {"dataloader_batch_size": 8,
                                 "optimizer_learning_rate": 1e-3,
                                 "grad_accum_steps": 4}
            p.ctx.update_node(node)
        clock = [500.0]
        auto = p.autoscaler(
            p.opt.LocalOptimizer(min_workers=1, max_workers=2),
            _FakeScaler(),
            strategy_generator=p.hyper.SimpleStrategyGenerator(),
            metric_collector=_collector(), refine_cooldown_secs=100.0,
            clock=lambda: clock[0])
        auto.maybe_refine_hyperparams()
        first = [dict(n.paral_config) for n in p.ctx.workers().values()]
        clock[0] += 50.0  # inside the cooldown: nothing
        auto.maybe_refine_hyperparams()
        clock[0] += 100.0  # past it: grows again (accum 2 -> 1)
        auto.maybe_refine_hyperparams()
        return first

    first = both(pkgs, run)
    for cfg in first:
        assert cfg["dataloader_batch_size"] == 16
        assert cfg["grad_accum_steps"] == 2
        assert cfg["dataloader_version"] == 1
        assert cfg["optimizer_learning_rate"] == pytest.approx(1e-3)
    for n in pkgs[1].ctx.workers().values():
        assert n.paral_config["dataloader_batch_size"] == 32
        assert n.paral_config["dataloader_version"] == 2


def case_autoscaler_planner_path_executes_one_plan_per_cooldown(pkgs):
    def run(p):
        class Rdzv:
            waiting = 4
            world = tuple(range(8))

            def world_snapshot(self):
                return types.SimpleNamespace(latest_world=self.world,
                                             num_waiting=self.waiting)

        p.add_workers(8)
        clock = [1000.0]
        sm = p.sm.SpeedMonitor(clock=lambda: clock[0])
        sm.collect_global_step(50, 900.0)
        for nid in range(8):
            sm.collect_step_digest(nid, {"count": 10, "mean_s": 1.0,
                                         "p50_s": 1.0, "p95_s": 1.05,
                                         "max_s": 1.1})
        sm.mark_downtime_start(ts=900.0)
        sm.mark_downtime_end(ts=910.0)
        rdzv = Rdzv()
        planner = p.planner.GoodputPlanner(
            speed_monitor=sm, rdzv_manager=rdzv, clock=lambda: clock[0],
            min_nodes=1, max_nodes=12, cooldown_s=100.0, horizon_s=600.0,
            hysteresis=1, decide_interval_s=1.0)
        auto = p.autoscaler(
            p.opt.LocalOptimizer(min_workers=1, max_workers=12),
            p.local_scaler(), speed_monitor=sm, planner=planner,
            clock=lambda: clock[0])
        out = [auto.sweep()]  # starts the warmup window
        clock[0] += 100.0
        out.append(auto.sweep())
        rdzv.waiting = 8
        clock[0] += 10.0
        out.append(auto.sweep())
        out.append(planner.export_state())
        return out

    none, plan, inside, state = both(pkgs, run)
    assert none is None
    assert plan["node_group_resources"][WORKER]["count"] == 12
    assert len(pkgs[1].ctx.alive_nodes(WORKER)) == 12
    assert [e["target_world"] for e in state["executed"]] == [12]
    assert inside is None or inside["node_group_resources"] == {}


def case_autoscaler_warmup_and_disable_follow_the_config(pkgs):
    def run(p):
        p.add_workers(2)
        clock = [1000.0]
        auto = p.autoscaler(
            p.opt.LocalOptimizer(min_workers=1, max_workers=2),
            p.local_scaler(), clock=lambda: clock[0])
        out = [auto.sweep()]
        clock[0] = 1089.0
        out.append(auto.sweep())
        clock[0] = 1091.0
        out.append(auto.sweep())
        p.config.update({"auto_worker_enabled": False})
        clock[0] = 1200.0
        out.append(auto.sweep())
        return out

    out = both(pkgs, run)
    assert out[0] is None and out[1] is None and out[3] is None
    assert out[2]["node_group_resources"][WORKER]["count"] == 2


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


def _params_of(case):
    marks = getattr(case, "pytestmark", [])
    if marks:
        name, values = marks[0].args
        return [(case, {name: v}) for v in values]
    return [(case, {})]


CASE_PARAMS = [cp for c in CASES for cp in _params_of(c)]


@pytest.mark.parametrize(
    "case,kw", CASE_PARAMS,
    ids=[c.__name__[5:] + "".join(f"[{v}]" for v in kw.values())
         for c, kw in CASE_PARAMS])
def test_autoscaler_case_matches_jax(case, kw, pkgs):
    """One JAX auto-scaler case's script through both packages: equal
    plans, suggestions, pushed configs and registries."""
    case(pkgs, **kw)


# -- the parallel-config chain ---------------------------------------------------


def test_paral_config_chain_sets_lr_scale_as_jax(pkgs, tmp_path, monkeypatch):
    """auto-scaler -> the node's versioned paral config -> the servicer's
    ``ParallelConfigRequest`` reply -> ``ParalConfigTuner``'s file ->
    ``poll_runtime_config``: the port trainer's ``lr_scale`` equals the
    JAX trainer's, and the step after it matches the JAX step (loss at
    rtol 1e-5, params at rtol 2e-2 / atol 1e-4, as
    ``tests/test_torch_trainer.py`` holds the accum-1 step)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dlrover_tpu.agent import paral_config_tuner as jtuner
    from dlrover_tpu.common import messages as jmsg
    from dlrover_tpu.common import serde as jserde
    from dlrover_tpu.master import servicer as jservicer
    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.parallel import MeshConfig, build_mesh
    from dlrover_tpu.train import trainer as jtrainer
    from dlrover_tpu_torch.agent import paral_config_tuner as ptuner
    from dlrover_tpu_torch.common import messages as pmsg
    from dlrover_tpu_torch.common import serde as pserde
    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.master import servicer as pservicer
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.models.convert import (params_from_jax,
                                                  params_to_numpy)
    from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig

    new_lr = 5e-3
    wire = {"jax": (jservicer, jmsg, jserde, jtuner),
            "port": (pservicer, pmsg, pserde, ptuner)}
    paths = {}
    for p in pkgs:
        servicer_mod, msg, serde, tuner_mod = wire[p.name]
        p.add_workers(2)
        auto = p.autoscaler(p.opt.LocalOptimizer(), _FakeScaler())
        plan = p.plan.ResourcePlan(paral_config={
            "optimizer_learning_rate": new_lr, "not_a_wire_field": 1})
        auto.execute_job_optimization_plan(plan)
        auto.execute_job_optimization_plan(plan)  # a no-op push
        servicer = servicer_mod.MasterServicer(job_context=p.ctx)

        class Client:
            def get_paral_config(self, servicer=servicer, msg=msg,
                                 serde=serde):
                return serde.deserialize(serde.serialize(servicer.get(
                    msg.ParallelConfigRequest(node_id=1))))

        paths[p.name] = str(tmp_path / f"{p.name}.json")
        tuner = tuner_mod.ParalConfigTuner(Client(), "job", 1,
                                           path=paths[p.name])
        assert tuner.poll_once() and not tuner.poll_once()
    assert _registry(pkgs[0]) == _registry(pkgs[1])
    files = {k: json.load(open(v)) for k, v in paths.items()}
    assert files["jax"] == files["port"]
    assert files["port"]["optimizer_learning_rate"] == new_lr
    assert files["port"]["dataloader_version"] == 1

    cfg_j = jllama.LlamaConfig.tiny()
    cfg_t = tllama.LlamaConfig.tiny()
    tc = TrainConfig(global_batch_size=2, micro_batch_size=2,
                     learning_rate=1e-2, warmup_steps=0, total_steps=4)
    np_params = jax.tree.map(
        np.asarray, jllama.init_params(cfg_j, jax.random.key(1)))
    batches = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (2, 1, 2, 16)).astype(np.int32)
    mc = MeshConfig(dp=1, fsdp=1, sp=1, tp=1)
    mesh = build_mesh(mc, devices=jax.devices()[:1])
    jtr = jtrainer.ElasticTrainer(
        lambda p, t: jllama.loss_fn(p, t, cfg_j, mesh),
        jllama.param_specs(cfg_j), mesh, mc,
        jtrainer.TrainConfig(**dataclasses.asdict(tc)))
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, np_params))
    ttr = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg_t), tc)
    tstate = ttr.init_state(params_from_jax(np_params, "cpu"))
    plain = ElasticTrainer(lambda p, t: tllama.loss_fn(p, t, cfg_t), tc)
    pstate = plain.init_state(params_from_jax(np_params, "cpu"))

    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_PATH", paths["jax"])
    jstate = jtr.poll_runtime_config(jstate)
    monkeypatch.setenv("DLROVER_TPU_PARAL_CONFIG_PATH", paths["port"])
    tstate = ttr.poll_runtime_config(tstate)
    assert isinstance(tstate["lr_scale"], float)
    assert tstate["lr_scale"] == pytest.approx(
        float(jstate["lr_scale"]), rel=1e-7)
    assert tstate["lr_scale"] == pytest.approx(new_lr / tc.learning_rate)
    # the same version again applies nothing
    assert ttr.poll_runtime_config(tstate)["lr_scale"] == tstate["lr_scale"]

    for batch in batches:
        jstate, jl = jtr.step(jstate, jnp.asarray(batch))
        tstate, tl = ttr.step(tstate, torch.from_numpy(batch).long())
        pstate, _ = plain.step(pstate, torch.from_numpy(batch).long())
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    moved = 0.0
    for (path, a), (_, b), (_, c) in zip(
            flatten(jax.tree.map(np.asarray, jstate["params"])),
            flatten(params_to_numpy(tstate["params"])),
            flatten(params_to_numpy(pstate["params"]))):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=1e-4, err_msg=path)
        moved = max(moved, float(np.abs(b - c).max()))
    # the scaled update is not the unscaled one
    assert moved > 1e-4
