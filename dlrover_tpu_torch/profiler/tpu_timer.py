"""Python side of the device timer: the port's own copy of
dlrover_tpu/profiler/tpu_timer.py, under the JAX name so a reader finds the
counterpart.

The JAX timer interposes the PJRT plugin of a TPU (native/tpu_timer/). On an
NVIDIA card the native part is ``csrc/cuda_hook.cc``, an ``LD_PRELOAD``
library that times NCCL's collectives and the trainer's step by CUDA
events, around the port's own copy of the JAX timer manager and metrics
server (``csrc/timer_manager.cc``, ``csrc/http_server.cc``). This module
builds it (g++, no CUDA header: first use, into ``build/torch_timer/`` at
the root of the checkout, keyed by a hash of the sources), gives the
workers' environment (``interposer_env``), checks that the library loads
(``verify_interposer``), scrapes its Prometheus endpoint into the
diagnosis pipeline (``TpuTimerMetricsSource``), and lets the trainer time
its step (``step_timer``). The flags, the Prometheus names and the
``/pending`` JSON are the JAX timer's, so either package's scraper reads
either endpoint.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import urllib.request
from pathlib import Path
from typing import Dict, Optional

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.constants import TpuTimerConsts
from dlrover_tpu_torch.common.log import logger

DEFAULT_PORT = TpuTimerConsts.DEFAULT_PORT
NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_timer"
CXXFLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall")
HOOK_LIB = "libdlrover_torch_timer.so"
#: bf16 dense peak TFLOP/s by the card's name (NVIDIA's data sheets; the
#: SXM part is the default H100 of the repo's chip runs)
PEAK_BF16_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 NVL", 835.0),
    ("H100", 989.0),
    ("H200", 989.0),
)


def native_build_dir() -> str:
    """Where this checkout's sources build: ``build/torch_timer/<hash>``,
    the hash of every file under ``csrc/``, the compiler and its flags."""
    digest = hashlib.sha256()
    for path in sorted(Path(NATIVE_DIR).iterdir()):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join((_cxx(),) + CXXFLAGS).encode())
    return str(BUILD_ROOT / digest.hexdigest()[:16])


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def build_native(force: bool = False) -> str:
    """Build the hook library and its test fixtures (idempotent); returns
    the hook's path. The fixtures: ``mock/libcuda.so.1``,
    ``mock/libnccl.so.2`` and ``mock/libmock_caller.so`` (the CPU tests'
    driver, NCCL and a library calling NCCL as torch does) and
    ``test_bucketing`` (the series cap's driver). Raises
    ``subprocess.CalledProcessError`` with the compiler's output when a
    build fails."""
    build = native_build_dir()
    hook = os.path.join(build, HOOK_LIB)
    if os.path.exists(hook) and not force:
        return hook
    tmp = f"{build}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    mock = os.path.join(tmp, "mock")
    os.makedirs(mock)
    src = lambda *names: [os.path.join(NATIVE_DIR, n) for n in names]  # noqa: E731
    cxx = [_cxx(), *CXXFLAGS]
    waves = [
        [
            cxx + ["-shared", "-o", os.path.join(tmp, HOOK_LIB)]
            + src("cuda_hook.cc", "timer_manager.cc", "http_server.cc")
            + ["-ldl", "-lpthread"],
            cxx + ["-o", os.path.join(tmp, "test_bucketing")]
            + src("test_bucketing.cc", "timer_manager.cc") + ["-lpthread"],
            cxx + ["-shared", "-Wl,-soname,libcuda.so.1", "-o",
                   os.path.join(mock, "libcuda.so.1")] + src("mock_cuda.cc"),
        ],
        [cxx + ["-shared", "-Wl,-soname,libnccl.so.2", "-o",
                os.path.join(mock, "libnccl.so.2")] + src("mock_nccl.cc")
         + [os.path.join(mock, "libcuda.so.1"), "-Wl,-rpath,$ORIGIN"]],
        [cxx + ["-shared", "-o", os.path.join(mock, "libmock_caller.so")]
         + src("mock_caller.cc")
         + [os.path.join(mock, "libnccl.so.2"), "-Wl,-rpath,$ORIGIN"]],
    ]
    try:
        for wave in waves:
            procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT))
                     for cmd in wave]
            for cmd, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    raise subprocess.CalledProcessError(
                        proc.returncode, cmd, output=out, stderr=out)
        try:
            os.replace(tmp, build)
        except OSError:
            if not os.path.exists(hook):  # else a concurrent build won
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return hook


def peak_bf16_tflops(card_name: str) -> float:
    """The card's bf16 dense peak from its name; 0 for an unknown card."""
    for key, tflops in PEAK_BF16_TFLOPS:
        if key in card_name:
            return tflops
    return 0.0


def card_name() -> str:
    """The name ``nvidia-smi`` gives card 0; "" without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


def interposer_env(
    port: int = DEFAULT_PORT,
    hang_timeout_secs: Optional[int] = None,
    peak_tflops: float = 0.0,
) -> Dict[str, str]:
    """The environment that loads the hook into a worker: ``LD_PRELOAD``,
    its metrics port, its hang timeout (``DLROVER_TPU_TIMER_HANG_SECS``,
    300 s unless set) and, for the live MFU gauge, the peak
    (``peak_tflops``, else ``DLROVER_TPU_PEAK_TFLOPS``, else card 0's
    bf16 dense peak by its name: 989 TFLOP/s for an H100 SXM). Builds the
    hook first."""
    lib = build_native()
    if hang_timeout_secs is None:
        hang_timeout_secs = int(flags.TIMER_HANG_SECS.get())
    if peak_tflops <= 0:
        peak_tflops = float(flags.PEAK_TFLOPS.get())
    if peak_tflops <= 0:
        peak_tflops = peak_bf16_tflops(card_name())
    env = {
        "LD_PRELOAD": lib,
        "DLROVER_TPU_TIMER_PORT": str(port),
        "DLROVER_TPU_TIMER_HANG_SECS": str(hang_timeout_secs),
    }
    if peak_tflops > 0:
        env["DLROVER_TPU_TIMER_PEAK_TFLOPS"] = f"{peak_tflops:g}"
    return env


_PROBE = """
import ctypes, sys
g = ctypes.CDLL(None)
g.dlrover_torch_timer_active()  # an AttributeError unless preloaded
if sys.argv[1] == "cuda":
    import torch  # loads libtorch_cuda and, with it, libnccl.so.2
    sys.exit(g.dlrover_torch_timer_check_driver()
             or g.dlrover_torch_timer_check_nccl())
"""


def verify_interposer(lib: str, accelerator: str, timeout: float = 120.0):
    """Check that ``lib`` preloads into a Python process and, for
    ``cuda``, that it finds the driver (``libcuda.so.1``) and the real
    NCCL torch loads. Raises ``RuntimeError`` naming what failed: a
    preload the loader ignores would otherwise run the job untimed."""
    env = dict(os.environ)
    env.update({"LD_PRELOAD": lib, "DLROVER_TPU_TIMER_PORT": "0"})
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE, accelerator],
                           env=env, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"tpu_timer load check timed out: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(
            f"tpu_timer hook {lib} failed its load check (exit "
            f"{r.returncode}):\n{(r.stderr or r.stdout)[-2000:]}")


class StepTimer:
    """The hook's C API in a process that preloaded it: ``begin`` opens
    ``name`` on a CUDA stream (a start event) with its per-execution
    flops, ``end`` records the end event; the poller thread ends the
    execution with the device time between them."""

    def __init__(self, lib: ctypes.CDLL):
        self._begin = lib.dlrover_torch_timer_begin
        self._begin.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                ctypes.c_double]
        self._begin.restype = ctypes.c_uint64
        self._end = lib.dlrover_torch_timer_end
        self._end.argtypes = [ctypes.c_uint64, ctypes.c_void_p]
        self._end.restype = None

    def begin(self, name: str, stream: int, flops: float = 0.0) -> int:
        return self._begin(name.encode(), stream, flops)

    def end(self, token: int, stream: int):
        self._end(token, stream)


_step_timer: Optional[StepTimer] = None
_probed = False


def step_timer() -> Optional[StepTimer]:
    """The hook's C API when this process preloaded it, else None."""
    global _step_timer, _probed
    if not _probed:
        _probed = True
        lib = ctypes.CDLL(None)
        if hasattr(lib, "dlrover_torch_timer_begin"):
            _step_timer = StepTimer(lib)
    return _step_timer


def _http_get(
    port: int, path: str, timeout: float = 2.0, retries: int = 1
) -> str:
    """GET from the local timer with a HARD timeout + bounded retry. A
    wedged worker (the exact failure the hang detector exists to catch)
    must never hang the diagnosis collector that is trying to diagnose
    it: every attempt is bounded, transient failures retry once with a
    warning, and the last failure propagates as ``OSError`` for the
    caller's existing degraded path."""
    url = f"http://127.0.0.1:{port}{path}"
    for attempt in range(retries + 1):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                return resp.read().decode()
        except OSError as e:
            if attempt >= retries:
                raise
            logger.warning(
                "tpu_timer scrape %s failed (%s); retry %d/%d",
                path, e, attempt + 1, retries,
            )
    raise OSError(f"unreachable: {url}")  # not reached; keeps mypy honest


def scrape_metrics(port: int = DEFAULT_PORT) -> Dict:
    """Prometheus text -> {plain: value, per_program: {name: {...}}}."""
    try:
        text = _http_get(port, "/metrics")
    except OSError:
        return {}
    out: Dict = {"programs": {}}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        try:
            num = float(value)
        except ValueError:
            continue
        if "{" in key:
            metric, label = key.split("{", 1)
            name = label.split('"')[1]
            short = metric.replace("dlrover_tpu_timer_", "")
            out["programs"].setdefault(name, {})[short] = num
        else:
            out[key.replace("dlrover_tpu_timer_", "")] = num
    return out


def dump_timeline(path: str, port: int = DEFAULT_PORT) -> bool:
    """Write the chrome-trace timeline (open in Perfetto / chrome://tracing)."""
    try:
        text = _http_get(port, "/timeline", timeout=10.0)
    except OSError as e:
        logger.warning("timeline fetch failed: %s", e)
        return False
    with open(path, "w") as f:
        f.write(text)
    logger.info("timeline written to %s", path)
    return True


class TpuTimerMetricsSource:
    """Callable for ``DiagnosisAgent.set_metrics_source``: condenses the
    scrape into the TpuMetricsRecord shape the master's hang-check operator
    consumes (reference XpuTimerMetricsCollector). Accepts one port or a
    list (one metrics server per local rank); a hang in ANY rank flags the
    host."""

    def __init__(self, ports=DEFAULT_PORT):
        self._ports = [ports] if isinstance(ports, int) else list(ports)

    def __call__(self) -> Dict:
        scrapes = [m for m in (scrape_metrics(p) for p in self._ports) if m]
        if not scrapes:
            return {}
        exec_total = 0.0
        exec_us = 0.0
        for m in scrapes:
            for p in m["programs"].values():
                exec_total += p.get("execute_total", 0)
                exec_us += p.get("execute_us_sum", 0)
        avg_ms = (exec_us / exec_total / 1000.0) if exec_total else 0.0
        mfus = [m["mfu"] for m in scrapes if m.get("mfu", 0) > 0]
        return {
            "hang": any(bool(m.get("hang", 0)) for m in scrapes),
            "step_latency_ms": avg_ms,
            "pending": int(sum(m.get("pending", 0) for m in scrapes)),
            "oldest_pending_us": int(
                max(m.get("oldest_pending_us", 0) for m in scrapes)
            ),
            "execute_total": int(exec_total),
            # live MFU (per-program cost attribution / peak): min across
            # local ranks — the slowest chip is the host's effective rate
            "mfu": min(mfus) if mfus else 0.0,
            "device_flops_total": sum(
                m.get("device_flops_total", 0) for m in scrapes
            ),
        }


def main(argv=None) -> int:
    """``python -m dlrover_tpu_torch.profiler.tpu_timer dump-timeline out.json``"""
    import argparse

    p = argparse.ArgumentParser("tpu_timer")
    p.add_argument("command", choices=["dump-timeline", "metrics", "build"])
    p.add_argument("output", nargs="?", default="timeline.json")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    args = p.parse_args(argv)
    if args.command == "build":
        print(build_native(force=True))
        return 0
    if args.command == "metrics":
        print(json.dumps(scrape_metrics(args.port), indent=2))
        return 0
    return 0 if dump_timeline(args.output, args.port) else 1


if __name__ == "__main__":
    raise SystemExit(main())
