"""The port's control plane end to end on the CPU: the CLI
(``dlrover_tpu_torch.run.elastic_run --standalone --accelerator cpu``)
spawns the port's master, runs the port's agent, which hosts the
flash-checkpoint saver, and supervises ``run/llama_pretrain.py`` workers
of tiny Llama.

- A run to its end: exit 0, the master records the job's exit as
  succeeded and holds the worker's last reported checkpoint step.
- A run whose worker is SIGKILLed once step 2 is staged: the agent persists
  step 2 at the breakpoint, restarts the worker
  (``worker-0-restart1.log``), which restores step 2 from shm and trains
  steps 3-4 to the losses of the run above, bitwise (the CPU path is
  deterministic, and both runs' workers start alike).
- A run that persists every 2nd step through the agent's saver and whose
  worker is SIGKILLed once step 3 is staged: the agent persists step 3 at
  the breakpoint into the worker's directory, beside the persisted step 2,
  and the restarted worker resumes from step 3.

Each run gets its own job name, so its shm segment, saver socket and logs
are its own, and removes them at the end.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import uuid

import pytest

from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
from dlrover_tpu_torch.checkpoint.saver import CheckpointPersister
from dlrover_tpu_torch.checkpoint.shm_handler import (
    SharedMemoryHandler,
    shm_name,
)
from dlrover_tpu_torch.common.ipc import default_socket_path

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN = os.path.join(REPO_ROOT, "dlrover_tpu_torch", "run",
                        "llama_pretrain.py")
CLI_TIMEOUT_S = 120
TRAIN_ARGS = ["--device", "cpu", "--model", "tiny", "--seq", "32",
              "--steps", "4", "--seed", "0", "--save-every", "0"]

# the killed run's worker: llama_pretrain's run, cut to KILL_AT steps in
# the first life, which then kills itself with that step staged (run()
# returns after the last save's stage); the second life restores and
# trains on
WORKER = """\
import json, os, signal, sys
from dlrover_tpu_torch.run import llama_pretrain
args = llama_pretrain.parse_args(sys.argv[1:])
first = os.environ["DLROVER_TPU_RESTART_COUNT"] == "0"
if first:
    args.steps = KILL_AT
result = llama_pretrain.run(args)
print("RESULT " + json.dumps({k: result[k] for k in
      ("start_step", "restore", "losses")}), flush=True)
if first:
    os.kill(os.getpid(), signal.SIGKILL)
"""


def _cleanup(job):
    h = SharedMemoryHandler(shm_name(job, 0, 0))
    if h.attach():
        h.close(unlink=True)
    shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)), ignore_errors=True)
    shutil.rmtree(os.path.dirname(os.path.dirname(
        default_socket_path(job, 0))), ignore_errors=True)


@pytest.fixture
def job():
    name = f"torch-elastic-{uuid.uuid4().hex[:10]}"
    _cleanup(name)
    yield name
    _cleanup(name)


def _run_cli(job, script, args, max_restarts=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # both runs' workers start alike, so their CPU sums are alike
    env["OMP_NUM_THREADS"] = "1"
    for k in [k for k in env if k.startswith("DLROVER_TPU_")
              and k != "DLROVER_TPU_LOG_LEVEL"]:
        del env[k]
    return subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
         "--standalone", "--nnodes=1", "--nproc_per_node=1",
         "--accelerator", "cpu", f"--job_name={job}",
         f"--max_restarts={max_restarts}", "--monitor_interval", "0.2",
         script, "--", *args],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)


def _log(job, restart):
    with open(os.path.join(agent_log_dir(job, 0),
                           f"worker-0-restart{restart}.log")) as f:
        return f.read()


def _whole_run(job, ckpt_dir):
    """An uninterrupted 4-step run under the CLI; returns its losses."""
    r = _run_cli(job, PRETRAIN, [*TRAIN_ARGS, "--ckpt-dir", ckpt_dir])
    log = _log(job, 0)
    assert r.returncode == 0, (r.stderr[-3000:], log[-2000:])
    assert "checkpoint saver started" in r.stderr
    assert "local master exiting: succeeded; checkpoint steps by node " \
           "{0: 4}" in r.stderr, r.stderr[-3000:]
    line = [x for x in log.splitlines() if x.startswith("params ")][-1]
    return ast.literal_eval(line.split(" losses ", 1)[1])


@pytest.fixture(scope="module")
def whole_losses(tmp_path_factory):
    """The losses of one uninterrupted run, which the killed runs match."""
    name = f"torch-elastic-{uuid.uuid4().hex[:10]}"
    _cleanup(name)
    try:
        losses = _whole_run(name, str(tmp_path_factory.mktemp("whole")))
    finally:
        _cleanup(name)
    assert len(losses) == 4
    return losses


def _killed_run(job, tmp_path, losses, save_every, kill_at):
    """A run whose worker kills itself with step ``kill_at`` staged; the
    agent must persist that step at the breakpoint and restart the worker,
    which resumes from shm and ends on the uninterrupted run's losses.
    Returns the checkpoint directory."""
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.replace("KILL_AT", str(kill_at)))
    ckpt_dir = str(tmp_path / "killed")
    args = [*TRAIN_ARGS, "--ckpt-dir", ckpt_dir]
    args[args.index("--save-every") + 1] = str(save_every)
    r = _run_cli(job, str(worker), args, max_restarts=1)
    first, second = _log(job, 0), _log(job, 1)
    assert r.returncode == 0, (r.stderr[-3000:], first[-1500:],
                               second[-1500:])
    # the agent saw the kill, classified it, persisted the staged step at
    # the breakpoint and restarted the worker
    assert "worker failed (exit -9)" in r.stderr
    assert "classified None -> restart" in r.stderr
    assert "breakpoint persist True" in r.stderr
    # the last commit: the breakpoint's step, or the second life's
    # periodic persist of step 4
    assert CheckpointPersister(job, 0).committed_step(ckpt_dir) == (
        4 if save_every else kill_at)
    killed = json.loads(first.split("RESULT ", 1)[1].splitlines()[0])
    assert killed["losses"] == losses[:kill_at]
    resumed = json.loads(second.split("RESULT ", 1)[1].splitlines()[0])
    assert resumed["start_step"] == kill_at
    assert resumed["restore"]["step"] == kill_at
    assert resumed["restore"]["tier"] == "shm"
    assert resumed["losses"] == losses[kill_at:]
    assert "local master exiting: succeeded; checkpoint steps by node " \
           "{0: 4}" in r.stderr, r.stderr[-3000:]
    return ckpt_dir


def test_cli_runs_and_restarts_a_killed_worker_from_shm(job, tmp_path,
                                                        whole_losses):
    _killed_run(job, tmp_path, whole_losses, save_every=0, kill_at=2)


def test_breakpoint_persist_after_a_periodic_persist(job, tmp_path,
                                                     whole_losses):
    """Persist every 2nd step through the agent's saver, then a kill with
    step 3 staged: the breakpoint's step lands in the worker's own
    directory, next to the periodic step 2."""
    ckpt_dir = _killed_run(job, tmp_path, whole_losses, save_every=2,
                           kill_at=3)
    # step 3 has no periodic persist: only the breakpoint writes it; a
    # step is whole on the object tier once the node's commit vote is in
    whole = sorted(int(n.split("-", 1)[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step-") and os.path.exists(
                       os.path.join(ckpt_dir, n, "node-0.done")))
    assert whole == [2, 3, 4], whole
