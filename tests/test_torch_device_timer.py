"""The device timer's hook (dlrover_tpu_torch/profiler/csrc/cuda_hook.cc) on
the CPU: built with g++ as tests/test_tpu_timer.py builds its interposer,
loaded with ``LD_PRELOAD`` into a small Python harness, against a mock
libcuda (events that pass once their stream's queued device work has ended,
or never), a mock libnccl and a library that calls NCCL as torch does
(``csrc/mock_*.cc``).

Covered: timed collectives, groups and step scopes; a hang at a shrunk
timeout with ``/pending`` naming the stuck collective; a latency equal to
the mock's device time, not the host's wait; the real symbol found in a
library loaded with ``RTLD_LOCAL``; the series cap and the latency
buckets; a child process that does not inherit the hook; a capturing
stream left untimed; the fatal exits; both packages' ``scrape_metrics``
and ``TpuTimerMetricsSource`` reading one endpoint to equal dicts; the
agent's load check and the launcher's exit when the build fails.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import uuid

import pytest

from dlrover_tpu.profiler import tpu_timer as jax_timer
from dlrover_tpu_torch.profiler import tpu_timer
from dlrover_tpu_torch.utils.net import find_free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the harness: loads the NCCL caller RTLD_LOCAL (ctypes' default), runs
#: the steps the test passes as JSON, then prints /metrics, /pending and
#: /timeline between markers
HARNESS = textwrap.dedent(r"""
    import ctypes, json, os, subprocess, sys, time, urllib.request
    mock, steps = sys.argv[1], json.loads(sys.argv[2])
    caller = ctypes.CDLL(os.path.join(mock, "libmock_caller.so"))
    caller.caller_collective.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.mock_cuda_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    cuda.mock_cuda_set_capturing.argtypes = [ctypes.c_void_p]
    hook = ctypes.CDLL(None)
    hook.dlrover_torch_timer_begin.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_double]
    hook.dlrover_torch_timer_begin.restype = ctypes.c_uint64
    hook.dlrover_torch_timer_end.argtypes = [ctypes.c_uint64, ctypes.c_void_p]
    port = hook.dlrover_torch_timer_port()
    tokens = {}
    for step in steps:
        op = step[0]
        if op == "coll":
            _, name, count, dtype, stream = step
            caller.caller_collective(name.encode(), count, dtype, stream)
        elif op == "group_start":
            caller.caller_group_start()
        elif op == "group_end":
            caller.caller_group_end()
        elif op == "begin":
            _, name, stream, flops = step
            tokens[name] = hook.dlrover_torch_timer_begin(
                name.encode(), stream, flops)
        elif op == "end":
            _, name, stream = step
            hook.dlrover_torch_timer_end(tokens[name], stream)
        elif op == "work":
            cuda.mock_cuda_enqueue(step[2], step[1])
        elif op == "capture":
            cuda.mock_cuda_set_capturing(step[1])
        elif op == "sleep":
            time.sleep(step[1])
        elif op == "child":
            print("==CHILD==")
            print(subprocess.run(step[1], capture_output=True,
                                 text=True).stdout)
        elif op == "ready":
            print("==READY==", flush=True)
    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.read().decode()
    print("==CALLS==", caller.caller_nccl_calls())
    print("==PRELOAD==", os.environ.get("LD_PRELOAD"))
    print("==METRICS==")
    print(get("/metrics"))
    print("==PENDING==")
    print(get("/pending"))
    print("==TIMELINE==")
    print(get("/timeline"))
""")


@pytest.fixture(scope="module")
def native():
    hook = tpu_timer.build_native()
    build = os.path.dirname(hook)
    return {"hook": hook, "mock": os.path.join(build, "mock"),
            "bucketing": os.path.join(build, "test_bucketing")}


def harness_env(native, port, extra=None, mock_driver=True):
    env = dict(os.environ)
    env.update({
        "LD_PRELOAD": native["hook"],
        "DLROVER_TPU_TIMER_PORT": str(port),
        "MOCK_NCCL_US": "20000",
    })
    if mock_driver:
        env["LD_LIBRARY_PATH"] = native["mock"]
    env.update(extra or {})
    return env


def run_harness(native, steps, extra=None, mock_driver=True):
    port = find_free_port()
    r = subprocess.run(
        [sys.executable, "-c", HARNESS, native["mock"], json.dumps(steps)],
        env=harness_env(native, port, extra, mock_driver),
        capture_output=True, text=True, timeout=120)
    return r


def section(out, name):
    body = out.split(f"=={name}==", 1)[1]
    return body.split("\n==", 1)[0].strip()


def metric(out, line_prefix):
    for line in section(out, "METRICS").splitlines():
        if line.startswith(line_prefix + " "):
            return float(line.rsplit(" ", 1)[1])
    raise KeyError(line_prefix)


def test_collectives_groups_and_step_scopes_are_timed(native):
    steps = [["coll", "AllReduce", 1000, 7, 16]] * 3 + [
        ["coll", "ReduceScatter", 256, 9, 16],
        ["coll", "AllGather", 128, 6, 16],
        ["coll", "Broadcast", 64, 4, 16],
        ["coll", "Reduce", 32, 2, 16],
        ["group_start"], ["coll", "Send", 10, 9, 16],
        ["coll", "Recv", 10, 9, 16], ["group_end"],
        ["group_start"], ["coll", "Send", 8, 0, 16], ["group_end"],
        ["begin", "train_step", 32, 5e11], ["work", 50000, 32],
        ["end", "train_step", 32],
        ["sleep", 0.6],
    ]
    r = run_harness(native, steps,
                    extra={"DLROVER_TPU_TIMER_PEAK_TFLOPS": "100"})
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert section(out, "CALLS") == "10"  # every call forwarded
    counts = {
        "nccl:AllReduce": 3, "nccl:ReduceScatter": 1, "nccl:AllGather": 1,
        "nccl:Broadcast": 1, "nccl:Reduce": 1, "nccl:Group": 1,
        "nccl:Send": 1, "train_step": 1,
    }
    for name, n in counts.items():
        assert metric(out, f'dlrover_tpu_timer_execute_total{{program="{name}"}}') == n
    # the cost is the call's bytes: count x the type's size
    assert metric(out, 'dlrover_tpu_timer_program_bytes{program="nccl:AllReduce"}') == 4000
    assert metric(out, 'dlrover_tpu_timer_program_bytes{program="nccl:ReduceScatter"}') == 512
    assert metric(out, 'dlrover_tpu_timer_program_bytes{program="nccl:AllGather"}') == 256
    assert metric(out, 'dlrover_tpu_timer_program_bytes{program="nccl:Group"}') == 40
    # a group is timed at its end, where its work is enqueued
    assert 39000 <= metric(out, 'dlrover_tpu_timer_execute_us_sum{program="nccl:Group"}') <= 41000
    # the step scope: its flops, and the MFU gauge from its device time
    assert metric(out, 'dlrover_tpu_timer_program_flops{program="train_step"}') == 5e11
    step_us = metric(out, 'dlrover_tpu_timer_execute_us_sum{program="train_step"}')
    assert 49000 <= step_us <= 51000
    want_mfu = 5e11 / step_us / 1e6 / 100
    assert metric(out, "dlrover_tpu_timer_mfu") == pytest.approx(want_mfu,
                                                                rel=1e-3)
    assert metric(out, "dlrover_tpu_timer_hang") == 0
    assert json.loads(section(out, "PENDING")) == {"hang": False,
                                                   "pending": []}
    cats = {e["cat"] for e in json.loads(section(out, "TIMELINE"))[
        "traceEvents"]}
    assert cats == {"execute"}


def test_hang_at_a_shrunk_timeout_names_the_stuck_collective(native):
    steps = [["coll", "AllReduce", 1 << 20, 7, 16], ["sleep", 2.0]]
    r = run_harness(native, steps, extra={
        "MOCK_NCCL_HANG": "1", "DLROVER_TPU_TIMER_HANG_SECS": "1"})
    assert r.returncode == 0, r.stderr
    assert metric(r.stdout, "dlrover_tpu_timer_hang") == 1
    assert metric(r.stdout, "dlrover_tpu_timer_pending") == 1
    pending = json.loads(section(r.stdout, "PENDING"))
    assert pending["hang"] is True
    assert [p["name"] for p in pending["pending"]] == ["nccl:AllReduce"]
    assert pending["pending"][0]["age_us"] > 1_000_000
    assert "HANG: 1 executions pending" in r.stderr
    assert "nccl:AllReduce" in r.stderr


def test_latency_is_device_time_not_the_host_wait(native):
    """Three collectives queued at once on one stream end 100, 200 and
    300 ms after their calls; each latency is its own 100 ms of device
    time, and a scope opened behind them counts only its own work."""
    steps = [["coll", "AllReduce", 1, 7, 16]] * 3 + [
        ["begin", "train_step", 16, 0.0], ["work", 30000, 16],
        ["end", "train_step", 16], ["sleep", 0.8]]
    r = run_harness(native, steps, extra={"MOCK_NCCL_US": "100000"})
    assert r.returncode == 0, r.stderr
    out = r.stdout
    total = metric(out, 'dlrover_tpu_timer_execute_us_sum{program="nccl:AllReduce"}')
    top = metric(out, 'dlrover_tpu_timer_execute_us_max{program="nccl:AllReduce"}')
    assert 3 * 99000 <= total <= 3 * 101000  # host waits would sum 600 ms
    assert top <= 101000
    step = metric(out, 'dlrover_tpu_timer_execute_us_sum{program="train_step"}')
    assert 29000 <= step <= 31000  # its host wait is 330 ms


def test_real_symbol_is_found_in_an_rtld_local_library(native):
    """The caller and its libnccl.so.2 are loaded RTLD_LOCAL: the global
    scope (RTLD_NEXT) does not see the real symbols, the hook finds them
    in the loaded library and forwards every call."""
    probe = textwrap.dedent("""
        import ctypes, os, sys
        caller = ctypes.CDLL(os.path.join(sys.argv[1], "libmock_caller.so"))
        caller.caller_collective.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
        glob = ctypes.CDLL(None)
        print(hasattr(glob, "mock_nccl_calls"))
        for _ in range(4):
            caller.caller_collective(b"AllReduce", 8, 7, 16)
        print(caller.caller_nccl_calls())
    """)
    r = subprocess.run([sys.executable, "-c", probe, native["mock"]],
                       env=harness_env(native, 0), capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "4"]


def test_latency_buckets(native):
    r = run_harness(native, [["coll", "AllReduce", 1, 7, 16]] * 5 +
                    [["sleep", 0.5]])
    assert r.returncode == 0, r.stderr
    out = r.stdout
    bucket = 'dlrover_tpu_timer_execute_latency_us_bucket{program="nccl:AllReduce",le="%s"}'
    assert metric(out, bucket % "32768") == 5
    assert metric(out, bucket % "16384") == 0
    assert metric(out, bucket % "+Inf") == 5
    gauge = 'dlrover_tpu_timer_execute_latency_us_%s{program="nccl:AllReduce"}'
    assert metric(out, gauge % "count") == 5
    assert 16384 < metric(out, gauge % "p50") <= 32768
    assert metric(out, gauge % "p50") <= metric(out, gauge % "p99") <= 32768


def test_series_cap_buckets_the_tail_by_throughput(native):
    r = subprocess.run([native["bucketing"], "2", "6"], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert 'dlrover_tpu_timer_execute_total{program="prog_0"} 12' in out
    assert 'dlrover_tpu_timer_execute_total{program="prog_1"} 10' in out
    assert 'execute_total{program="prog_2"' not in out
    assert 'execute_total{program="prog_5"' not in out
    assert "dlrover_tpu_timer_bucketed_programs 4" in out
    tail = sum(int(m) for m in re.findall(
        r'execute_total\{bucket="[^"]+"\} (\d+)', out))
    assert tail == 8 + 6 + 4 + 2
    assert 'execute_latency_us_p50{bucket="flops_1e' in out


def test_a_child_process_does_not_inherit_the_hook(native):
    """The constructor takes the hook out of LD_PRELOAD and keeps every
    other entry, so a worker's children (nvcc, for one) start clean."""
    other = "/lib/x86_64-linux-gnu/libm.so.6"
    if not os.path.exists(other):
        other = ""
    preload = native["hook"] + (":" + other if other else "")
    steps = [["child", ["sh", "-c", "echo preload=$LD_PRELOAD; grep -c "
                        "libdlrover_torch_timer /proc/self/maps"]]]
    r = run_harness(native, steps, extra={"LD_PRELOAD": preload})
    assert r.returncode == 0, r.stderr
    child = section(r.stdout, "CHILD").split()
    assert child == [f"preload={other}", "0"]
    assert section(r.stdout, "PRELOAD") == (other or "None")


def test_a_capturing_stream_is_not_timed(native):
    steps = [["capture", 16], ["coll", "AllReduce", 8, 7, 16],
             ["coll", "AllReduce", 8, 7, 48], ["sleep", 0.3]]
    r = run_harness(native, steps)
    assert r.returncode == 0, r.stderr
    assert section(r.stdout, "CALLS") == "2"
    assert metric(r.stdout, 'dlrover_tpu_timer_execute_total{program="nccl:AllReduce"}') == 1


def test_a_hook_without_the_driver_ends_the_process(native):
    """No libcuda.so.1 on the loader's path (a host without a card has none): the
    first timed call ends the process with exit 70 rather than running
    untimed."""
    probe = textwrap.dedent("""
        import ctypes
        g = ctypes.CDLL(None)
        g.dlrover_torch_timer_begin.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_double]
        g.dlrover_torch_timer_begin(b"train_step", 16, 0.0)
        print("timed without a driver")
    """)
    r = subprocess.run([sys.executable, "-c", probe],
                       env=harness_env(native, 0, mock_driver=False),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 70, (r.stdout, r.stderr)
    assert "FATAL: the CUDA driver is unusable" in r.stderr


def test_a_hook_without_the_real_nccl_ends_the_process(native):
    probe = textwrap.dedent("""
        import ctypes
        ctypes.CDLL(None).ncclAllReduce(None, None, 1, 7, 0, None, None)
    """)
    r = subprocess.run([sys.executable, "-c", probe],
                       env=harness_env(native, 0), capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 70
    assert "cannot find the real NCCL symbol" in r.stderr


def test_both_packages_scrape_one_endpoint_alike(native):
    port = find_free_port()
    steps = [["coll", "AllReduce", 1000, 7, 16]] * 3 + [
        ["begin", "train_step", 32, 2e11], ["work", 40000, 32],
        ["end", "train_step", 32], ["sleep", 0.5], ["ready"],
        ["sleep", 30.0]]
    proc = subprocess.Popen(
        [sys.executable, "-c", HARNESS, native["mock"], json.dumps(steps)],
        env=harness_env(native, port,
                        {"DLROVER_TPU_TIMER_PEAK_TFLOPS": "989"}),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for line in proc.stdout:
            if line.strip() == "==READY==":
                break
        dead = find_free_port()
        for _ in range(3):
            p, j = tpu_timer.scrape_metrics(port), jax_timer.scrape_metrics(
                port)
            p.pop("uptime_us")
            j.pop("uptime_us")
            if p == j:
                break
        assert p == j
        assert p["programs"]["nccl:AllReduce"]["execute_total"] == 3
        assert p["mfu"] > 0
        for ports in (port, [port, dead]):
            assert (tpu_timer.TpuTimerMetricsSource(ports)()
                    == jax_timer.TpuTimerMetricsSource(ports)())
        assert tpu_timer.TpuTimerMetricsSource(dead)() == {}
        pend = tpu_timer._http_get(port, "/pending")
        assert json.loads(pend) == {"hang": False, "pending": []}
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_chip_smoke_reads_the_all_reduces_once_settled(native):
    """chip_smoke.py's read of a rank's all-reduces waits until the hook
    ended every collective the device ran: three of 20 ms each, queued on
    one stream, read at once, count three and 60 ms of device time."""
    import types

    sys.path.insert(0, REPO)
    import chip_smoke

    port = find_free_port()
    steps = [["coll", "AllReduce", 1000, 7, 16]] * 3 + [
        ["ready"], ["sleep", 30.0]]
    proc = subprocess.Popen(
        [sys.executable, "-c", HARNESS, native["mock"], json.dumps(steps)],
        env=harness_env(native, port), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        for line in proc.stdout:
            if line.strip() == "==READY==":
                break
        drained = types.SimpleNamespace(
            cuda=types.SimpleNamespace(synchronize=lambda: None))
        got = chip_smoke.settled_all_reduces(drained, port)
        assert got["count"] == 3
        assert got["us_sum"] == pytest.approx(60_000, rel=0.01)
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_http_get_bounded_timeout_and_retry_with_warning(monkeypatch):
    calls = []

    def flaky_urlopen(url, timeout=None):
        calls.append((url, timeout))
        if len(calls) == 1:
            raise OSError("connection reset")

        class Resp:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def read(self):
                return b"pong"

        return Resp()

    monkeypatch.setattr(tpu_timer.urllib.request, "urlopen", flaky_urlopen)
    assert tpu_timer._http_get(9999, "/metrics") == "pong"
    assert len(calls) == 2 and all(t and t > 0 for _, t in calls)
    calls.clear()

    def dead_urlopen(url, timeout=None):
        calls.append((url, timeout))
        raise OSError("down")

    monkeypatch.setattr(tpu_timer.urllib.request, "urlopen", dead_urlopen)
    with pytest.raises(OSError):
        tpu_timer._http_get(9999, "/metrics")
    assert len(calls) == 2
    assert tpu_timer.scrape_metrics(9999) == {}
    from dlrover_tpu_torch.profiler.hang_dump import HangDumper

    assert "error" in HangDumper._fetch_pending(9999)


@pytest.mark.parametrize("name,tflops", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA H200", 989.0), ("NVIDIA A100-SXM4-80GB", 0.0)])
def test_peak_from_the_card_name(name, tflops):
    assert tpu_timer.peak_bf16_tflops(name) == tflops


def test_interposer_env(native, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_TIMER_HANG_SECS", "25")
    monkeypatch.setenv("DLROVER_TPU_PEAK_TFLOPS", "989")
    env = tpu_timer.interposer_env(port=18900)
    assert env == {"LD_PRELOAD": native["hook"],
                   "DLROVER_TPU_TIMER_PORT": "18900",
                   "DLROVER_TPU_TIMER_HANG_SECS": "25",
                   "DLROVER_TPU_TIMER_PEAK_TFLOPS": "989"}


def test_load_check(native, tmp_path):
    tpu_timer.verify_interposer(native["hook"], "cpu")
    bad = tmp_path / "libnot_a_hook.so"
    bad.write_text("not an ELF file")
    with pytest.raises(RuntimeError, match="failed its load check"):
        tpu_timer.verify_interposer(str(bad), "cpu")


def _cli(tmp_path, script, extra_env, extra_args=()):
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO, "TMPDIR": str(tmp_path)})
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
         "--standalone", "--accelerator", "cpu", "--tpu-timer",
         "--tpu-timer-port", str(find_free_port()), "--monitor_interval",
         "0.5", f"--job_name=timer-{uuid.uuid4().hex[:8]}", *extra_args,
         str(script)],
        env=env, capture_output=True, text=True, timeout=240)


def test_a_failed_timer_build_stops_the_launcher(tmp_path):
    script = tmp_path / "worker.py"
    marker = tmp_path / "ran"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    r = _cli(tmp_path, script, {"CXX": "false"})
    assert r.returncode == 1, r.stderr[-3000:]
    assert "tpu_timer native build failed" in r.stderr
    assert not marker.exists()  # no worker ran untimed


def test_workers_run_under_the_timer(tmp_path):
    """``elastic_run --tpu-timer`` on the CPU: the worker has the hook
    loaded, its environment no longer names it, its stack dumper is
    installed, and its metrics answer on the agent's port for its rank."""
    script = tmp_path / "worker.py"
    out = tmp_path / "out.json"
    script.write_text(textwrap.dedent(f"""
        import ctypes, json, os, signal
        from dlrover_tpu_torch.train import bootstrap
        from dlrover_tpu_torch.profiler import tpu_timer
        ctx = bootstrap.init()
        port = int(os.environ["DLROVER_TPU_TIMER_PORT"])
        json.dump({{
            "active": ctypes.CDLL(None).dlrover_torch_timer_active(),
            "preload": os.environ.get("LD_PRELOAD"),
            "handler": signal.getsignal(signal.SIGUSR2) is not None,
            "stack_dir": os.environ["DLROVER_TPU_STACK_DIR"],
            "served": bool(tpu_timer.scrape_metrics(port)),
            "step_timer": tpu_timer.step_timer() is not None,
        }}, open({str(out)!r}, "w"))
    """))
    r = _cli(tmp_path, script, {})
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(out.read_text())
    assert got["active"] == 1 and got["preload"] is None
    assert got["served"] and got["step_timer"]
    assert got["stack_dir"].endswith(os.path.join("node-0", "hang"))
    assert "tpu_timer on ports" in r.stderr
