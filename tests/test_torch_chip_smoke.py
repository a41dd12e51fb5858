"""chip_smoke.py's tables against the CUDA sources, on the CPU.

Every ``__global__`` kernel in ``dlrover_tpu_torch/ops/csrc/*.cu`` is held
against its plain version by ``chip_smoke.py`` (``KERNELS`` or
``CE_KERNELS``) and has one SASS expectation (wgmma + TMA, or neither),
and the bounds that the kernels' times are read against stay where they
were computed, so the yardstick of a comparison cannot drift unnoticed.
Phase 4d's pure checks: the shard accounting fails on each fault it is
there to catch, and the script's own replica of the sampler's order and of
the loader's rows equals the port's sampler and loader. The master's
downtime bracket and gauges (phases 4c and 4d), read from the port's own
master, and the four-card leg's rank agreement and staged share: each
check passes on good input and fails on each fault it is there to catch.
"""

import os
import re
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
from dlrover_tpu_torch.ops import cuda_build  # noqa: E402
from dlrover_tpu_torch.ops import fused_ce as fce  # noqa: E402


def _global_kernels():
    """{kernel name without ``_kernel``: source} over every csrc/*.cu."""
    found = {}
    for name in cuda_build.sources():
        text = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        for kernel in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)_kernel\s*\(", text):
            found[kernel] = name
    return found


def test_every_kernel_is_held_and_has_one_sass_expectation():
    """Eight kernels have a wrapper of their own; the ninth, flash dk/dv's
    group sum, runs in flash_bwd_dkv's launch and is held with it."""
    kernels = _global_kernels()
    held = {name for name, _, _ in chip_smoke.KERNELS + chip_smoke.CE_KERNELS}
    assert len(held) == 8 and len(kernels) == 9
    assert chip_smoke.HELD_BY == {"flash_dkv_sum": "flash_bwd_dkv"}
    assert set(kernels) == held | set(chip_smoke.HELD_BY)
    assert set(chip_smoke.HELD_BY.values()) <= held
    wgmma = set(chip_smoke.WGMMA_KERNELS)
    plain = set(chip_smoke.NO_WGMMA_KERNELS)
    assert not wgmma & plain
    assert wgmma | plain == held | set(chip_smoke.HELD_BY)
    assert wgmma == {"fused_ce_fwd", "fused_ce_bwd_q", "fused_ce_bwd_dx",
                     "fused_ce_bwd_dw", "flash_fwd", "flash_bwd_dq",
                     "flash_bwd_dkv"}
    assert plain == {"fused_ce_merge", "flash_dkv_sum"}
    # each table's source is the file the kernel is defined in
    for name, _, _ in chip_smoke.KERNELS:
        assert chip_smoke.SOURCE.endswith(f"/{kernels[name]}.cu")
    for name, parent in chip_smoke.HELD_BY.items():
        assert kernels[name] == kernels[parent]
    for name, _, _ in chip_smoke.CE_KERNELS:
        assert chip_smoke.CE_SOURCE.endswith(f"/{kernels[name]}.cu")


def test_sass_check_holds_each_kernel_instance():
    """check_sass fails a wgmma kernel instance without HGMMA or UTMALDG, a
    plain one with either, and a kernel missing from the SASS."""
    good = {"flash_fwd<64>": (12, 3), "flash_fwd<128>": (16, 6),
            "flash_bwd_dq<64>": (24, 4), "flash_bwd_dq<128>": (40, 8),
            "flash_bwd_dkv<64>": (16, 4), "flash_bwd_dkv<128>": (24, 8),
            "fused_ce_fwd": (4, 5), "fused_ce_merge": (0, 0),
            "fused_ce_bwd_q": (4, 5), "fused_ce_bwd_dx": (4, 2),
            "fused_ce_bwd_dw": (4, 6), "flash_dkv_sum<64>": (0, 0),
            "flash_dkv_sum<128>": (0, 0)}
    chip_smoke.check_sass(good)
    for inst, bad in (("flash_dkv_sum<128>", (1, 0)),
                      ("flash_fwd<64>", (12, 0)),
                      ("fused_ce_bwd_dw", (0, 6)),
                      ("flash_bwd_dkv<128>", (24, 0)),
                      ("flash_bwd_dq<64>", (0, 4)),
                      # the forward runs the wgmma loop: plain SASS fails
                      ("fused_ce_fwd", (0, 0)),
                      ("fused_ce_merge", (1, 0))):
        with pytest.raises(chip_smoke.SmokeFailure, match=re.escape(inst)):
            chip_smoke.check_sass({**good, inst: bad})
    missing = {k: v for k, v in good.items() if k != "fused_ce_merge"}
    with pytest.raises(chip_smoke.SmokeFailure, match="fused_ce_merge"):
        chip_smoke.check_sass(missing)
    missing = {k: v for k, v in good.items()
               if not k.startswith("flash_dkv_sum")}
    with pytest.raises(chip_smoke.SmokeFailure, match="flash_dkv_sum"):
        chip_smoke.check_sass(missing)


@pytest.mark.parametrize("kernel,ms", [
    ("flash_fwd", 0.0348), ("flash_bwd_dq", 0.0521), ("flash_bwd_dkv", 0.0695),
])
def test_flash_bounds_at_the_main_case(kernel, ms):
    """Causal b=1 s=2048 h=32 d=128: 4 d (or 6 d, 8 d) FLOPs a visible
    (q, k) pair over 989 TFLOP/s."""
    bound_ms, by = chip_smoke.bounds(chip_smoke.MAIN_CASE)[kernel]
    assert by == "operations"
    assert bound_ms == pytest.approx(ms, abs=5e-5)


def test_bwd_dw_bound_at_the_main_chunk():
    """2 d n cw FLOPs of one 8192-column chunk over 989 TFLOP/s."""
    bounds = chip_smoke.ce_bounds(2048, 4096, 128256, 8192, fce.FWD_TILE)
    bound_ms, by = bounds["fused_ce_bwd_dw"]
    assert by == "operations"
    assert bound_ms == pytest.approx(0.1390, abs=5e-5)
    assert fce.BWD_CHUNK == 8192


def test_ce_fwd_and_merge_bounds_at_the_main_shape():
    """n 2048, d 4096, v 128256: the forward's 2 n d v FLOPs over 989
    TFLOP/s; the merge reads 3 f32 partials for each token of each of the
    501 256-column tiles and writes logz and gold (half the bytes of
    128-column tiles)."""
    bounds = chip_smoke.ce_bounds(2048, 4096, 128256, 8192, fce.FWD_TILE)
    assert fce.FWD_TILE == 256
    assert bounds["fused_ce_fwd"] == (pytest.approx(2.1757, abs=5e-5),
                                      "operations")
    merge_bytes = 3 * 2048 * 501 * 4 + 2 * 2048 * 4
    assert chip_smoke.ce_work(2048, 4096, 128256, 8192,
                              fce.FWD_TILE)["fused_ce_merge"] == (
        None, merge_bytes)
    assert bounds["fused_ce_merge"] == (
        pytest.approx(merge_bytes / 3.35e12 * 1e3), "bytes")
    assert bounds["fused_ce_merge"][0] == pytest.approx(0.0037, abs=5e-5)


class _FakeCuda:
    """The parts of ``torch.cuda`` that ``graph_ms`` and ``cuda_ms`` touch,
    recording what runs where: each call of the timed function notes
    whether a graph was capturing, and each event reads a fixed 60 ms."""

    def __init__(self):
        self.capturing = False
        self.replays = 0
        self.streams = []
        fake = self

        class Stream:
            def wait_stream(self, other):
                pass

        class Graph:
            def replay(self):
                fake.replays += 1

        class GraphContext:
            def __init__(self, graph, stream=None):
                fake.streams.append(stream)

            def __enter__(self):
                fake.capturing = True

            def __exit__(self, *exc):
                fake.capturing = False

        class StreamContext:
            def __init__(self, stream):
                pass

            def __enter__(self):
                pass

            def __exit__(self, *exc):
                pass

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def elapsed_time(self, end):
                return 60.0

        self.Stream, self.CUDAGraph, self.Event = Stream, Graph, Event
        self.graph, self.stream = GraphContext, StreamContext
        self.current_stream = Stream

    def synchronize(self):
        pass


@pytest.mark.parametrize("given_stream", [False, True])
def test_graph_ms_times_replays_of_a_captured_graph(given_stream):
    """graph_ms warms ``fn`` up outside capture, captures ``reps`` calls in
    one graph on the given stream (or a new one), and reads the events
    around ``iters`` replays as ``reps * iters`` calls."""
    cuda = _FakeCuda()
    fake_torch = type("FakeTorch", (), {"cuda": cuda})()
    calls = []
    stream = cuda.Stream() if given_stream else None
    ms = chip_smoke.graph_ms(
        fake_torch, lambda: calls.append(cuda.capturing), stream=stream,
        reps=4, iters=3)
    assert calls == [False] * 3 + [True] * 4
    assert cuda.replays == 1 + 3  # one warm-up replay, then the timed ones
    assert ms == pytest.approx(60.0 / 3 / 4)
    (captured_on,) = cuda.streams
    if given_stream:
        assert captured_on is stream
    else:
        assert isinstance(captured_on, cuda.Stream)


def test_checkpoint_state_bytes_and_bounds():
    """Phase 4c's state at the main path's size: 1,923,125,248 f32 params
    and adam's mu and nu; the snapshot reads and writes each byte once at
    3.35 TB/s; the device-to-host copy moves it over PCIe Gen5 x16 (the
    H100 SXM's link, taken where nvidia-smi reads none)."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.run import llama_pretrain

    n = llama.param_count(llama_pretrain.model_config("8b", 4))
    assert n == 1_923_125_248
    nbytes = chip_smoke.ckpt_state_bytes(n)
    assert nbytes == 23_077_502_976
    assert chip_smoke.snapshot_bound_ms(nbytes) == pytest.approx(13.8,
                                                                abs=0.05)
    gen, width, note = chip_smoke.pcie_link("[N/A], [N/A]")
    assert (gen, width) == (5, 16) and "N/A" in note
    assert chip_smoke.pcie_link("4, 8")[:2] == (4, 8)
    # 32 GT/s x 16 lanes x 128/130 / 8 = 63.0 GB/s
    assert chip_smoke.pcie_bytes_per_s(5, 16) == pytest.approx(63.015e9,
                                                               rel=1e-4)
    assert nbytes / chip_smoke.pcie_bytes_per_s(gen, width) == pytest.approx(
        0.366, abs=5e-4)


@pytest.mark.parametrize("free_blocks,ok", [(10, False), (2_000_000, True)])
def test_check_space_refuses_a_small_volume(free_blocks, ok):
    """check_space reads the volume's free bytes (f_bavail x f_frsize) and
    fails, naming the shortfall, when the state does not fit."""
    import types

    def statvfs(path):
        return types.SimpleNamespace(f_bavail=free_blocks, f_frsize=4096)

    need = 1_000_000_000
    if ok:
        assert chip_smoke.check_space("/dev/shm", need, "shm",
                                      statvfs) == free_blocks * 4096
        return
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=f"{need - 10 * 4096} bytes short"):
        chip_smoke.check_space("/dev/shm", need, "shm", statvfs)


def test_crc_comparison_fails_on_one_flipped_byte():
    """The CRC32 table of staged leaves against the restored ones: equal
    tables pass; one flipped byte, or a missing leaf, fails, naming it."""
    import numpy as np

    rng = np.random.default_rng(0)
    leaves = {f"['params']['w{i}']": rng.standard_normal(1000).astype(
        np.float32) for i in range(4)}
    leaves["['step']"] = np.asarray(3, np.int32)
    want = chip_smoke.crc_table(leaves)
    chip_smoke.compare_crcs(want, chip_smoke.crc_table(
        {k: v.copy() for k, v in leaves.items()}), "same")
    flipped = {k: v.copy() for k, v in leaves.items()}
    flipped["['params']['w2']"].view(np.uint8)[1234] ^= 0x01
    with pytest.raises(chip_smoke.SmokeFailure, match=r"\['w2'\]"):
        chip_smoke.compare_crcs(want, chip_smoke.crc_table(flipped),
                                "flipped")
    missing = dict(leaves)
    del missing["['step']"]
    with pytest.raises(chip_smoke.SmokeFailure, match="missing"):
        chip_smoke.compare_crcs(want, chip_smoke.crc_table(missing),
                                "missing")


def test_checkpoint_disk_peak_is_one_persisted_step():
    """Phase 4c asks the disk for one persisted step of the main path's
    state on two tiers, and the manifests' slack: each leg removes its
    directory before the next persists, so the three persisted steps
    (the save run's, the agent's, the breakpoint's) never sum."""
    nbytes = chip_smoke.ckpt_state_bytes(1_923_125_248)
    peak = chip_smoke.ckpt_disk_peak(nbytes)
    assert peak == 2 * 23_077_502_976 + (64 << 20)
    assert peak < 3 * nbytes


def test_breakpoint_step_crcs_must_match_the_killed_child():
    """The breakpoint step's manifest and its disk restore are held to the
    CRC32s the killed child staged: equal tables pass; one flipped byte in
    either, or a leaf missing from the restore, fails and says which."""
    import numpy as np

    rng = np.random.default_rng(1)
    leaves = {f"['params']['w{i}']": rng.standard_normal(500).astype(
        np.float32) for i in range(3)}
    staged = chip_smoke.crc_table(leaves)
    chip_smoke.check_breakpoint_step(staged, dict(staged), dict(staged))
    flipped = {k: v.copy() for k, v in leaves.items()}
    flipped["['params']['w1']"].view(np.uint8)[7] ^= 0x10
    bad = chip_smoke.crc_table(flipped)
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=r"breakpoint manifest.*\['w1'\]"):
        chip_smoke.check_breakpoint_step(staged, bad, dict(staged))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match=r"disk restore.*\['w1'\]"):
        chip_smoke.check_breakpoint_step(staged, dict(staged), bad)
    missing = dict(staged)
    del missing["['params']['w0']"]
    with pytest.raises(chip_smoke.SmokeFailure, match="missing"):
        chip_smoke.check_breakpoint_step(staged, dict(staged), missing)


def _agent_saves(persist2="queued", wait3=12.5):
    stage = {"step": 0, "mode": "device_snapshot", "wait_s": 0.001}
    return [
        {"step": 1, "blocking_s": 9.1, "stage": dict(stage)},
        {"step": 2, "blocking_s": 0.02,
         "stage": dict(stage, persist=persist2)},
        {"step": 3, "blocking_s": 0.03, "stage": dict(stage, wait_s=wait3)},
    ]


def test_agent_persist_check():
    """The agent leg passes when save 2 queued its persist and the saver
    copied and committed step 2 alone; it returns step 2's pause, step 3's
    wait and the saver's copy and fanout seconds. An inline persist, a
    saver that copied another step or a commit of another step fails."""
    log = [{"step": 2, "steps": [2], "copy_s": 28.0, "fanout_s": 30.0}]
    assert chip_smoke.check_agent_persist(_agent_saves(), log, 2) == (
        0.02, 12.5, 28.0, 30.0)
    with pytest.raises(chip_smoke.SmokeFailure, match="queued"):
        chip_smoke.check_agent_persist(_agent_saves("inline"), log, 2)
    with pytest.raises(chip_smoke.SmokeFailure, match="persists of step 2"):
        chip_smoke.check_agent_persist(
            _agent_saves(), [dict(log[0], steps=[])], 2)
    with pytest.raises(chip_smoke.SmokeFailure, match="committed step 1"):
        chip_smoke.check_agent_persist(_agent_saves(), log, 1)


# -- phase 4d: the data plane -----------------------------------------------


def _lives():
    """Two lives as the shard leg sees them when all goes well: the first
    leased 0-3 then 4-7 (acking 0-3), trained 0-5 and died; the second
    leased 4-7 again, then 8-15 (acking as it went)."""
    ranges = [(s, s + 2) for s in range(0, 32, 2)]
    crc = {r: 1000 + r[0] for r in ranges}

    def shard(tid):
        return [tid, *ranges[tid], crc[ranges[tid]]]

    def grant(ids):
        return [[t, *ranges[t]] for t in ids]

    first = {"shards": [shard(t) for t in range(6)], "leases": [
        {"granted": grant(range(4)), "acked": []},
        {"granted": grant(range(4, 8)), "acked": [0, 1, 2, 3]}]}
    second = {"shards": [shard(t) for t in range(4, 16)], "leases": [
        {"granted": grant(range(4, 8)), "acked": []},
        {"granted": grant(range(8, 12)), "acked": [4, 5, 6, 7]},
        {"granted": grant(range(12, 16)), "acked": [8, 9, 10, 11]},
        {"granted": [], "acked": [12, 13, 14, 15]}]}
    return first, second, ranges, crc


def test_shard_accounting_passes_and_returns_the_redelivered():
    first, second, ranges, crc = _lives()
    assert chip_smoke.check_shard_accounting(first, second, ranges, crc) == [
        (8, 10), (10, 12)]


def test_shard_accounting_fails_on_each_fault():
    first, second, ranges, crc = _lives()
    # a range no life trained
    cut = dict(second, shards=second["shards"][:-1])
    with pytest.raises(chip_smoke.SmokeFailure, match=r"no life trained "
                       r"\[\(30, 32\)\]"):
        chip_smoke.check_shard_accounting(first, cut, ranges, crc)
    # a range the master acked in the first life reaches the second
    leaked = dict(second, shards=[[0, 0, 2, crc[(0, 2)]]]
                  + second["shards"])
    with pytest.raises(chip_smoke.SmokeFailure, match="acked in the first "
                       "life"):
        chip_smoke.check_shard_accounting(first, leaked, ranges, crc)
    # a re-delivered range the first life did not hold un-acked
    unheld = {"shards": first["shards"], "leases": [
        first["leases"][0], {"granted": first["leases"][1]["granted"][:1],
                             "acked": [0, 1, 2, 3]}]}
    with pytest.raises(chip_smoke.SmokeFailure, match=r"\[\(10, 12\)\] "
                       "were trained in both lives"):
        chip_smoke.check_shard_accounting(unheld, second, ranges, crc)
    # a step's tokens unlike the file's rows
    bad = dict(second, shards=[list(x) for x in second["shards"]])
    bad["shards"][3][3] += 1
    with pytest.raises(chip_smoke.SmokeFailure, match="CRC32"):
        chip_smoke.check_shard_accounting(first, bad, ranges, crc)
    # one life training a range twice
    twice = dict(second, shards=second["shards"] + second["shards"][-1:])
    with pytest.raises(chip_smoke.SmokeFailure, match="twice"):
        chip_smoke.check_shard_accounting(first, twice, ranges, crc)


def test_sampler_order_replica_equals_the_port_sampler(tmp_path):
    """sampler_order and loader_rows, computed by the script on its own,
    equal the port's sampler and its loader over the corpus the script
    writes (small here: 8 sequences of 16 tokens)."""
    import numpy as np

    from dlrover_tpu_torch.train.data import (
        ElasticDataLoader,
        ElasticDistributedSampler,
    )
    from dlrover_tpu_torch.train.datasets import TokenFileDataset

    for epoch in (0, 1, 2):
        sampler = ElasticDistributedSampler(
            dataset_size=32, batch_size=2, num_replicas=1, rank=0,
            shuffle=True, seed=1)
        sampler.state.epoch = epoch
        np.testing.assert_array_equal(chip_smoke.sampler_order(32, 1, epoch),
                                      sampler._global_order())
    path = str(tmp_path / "c.bin")
    tokens = chip_smoke.write_corpus(path, seed=3, records=8, seq=16,
                                     vocab=300)
    assert tokens.shape == (8, 16) and tokens.max() < 300
    assert os.path.getsize(path) == 8 * 16 * 4
    chip_smoke.write_corpus(path, seed=3, records=8, seq=16, vocab=300)
    assert os.path.getsize(path) == 8 * 16 * 4  # rewritten, not appended
    ds = TokenFileDataset(path, 16, dtype="uint32")
    sampler = ElasticDistributedSampler(dataset_size=len(ds), batch_size=2,
                                        num_replicas=1, rank=0, shuffle=True,
                                        seed=chip_smoke.DATA_SAMPLER_SEED)
    loader = ElasticDataLoader(ds, batch_size=2, sampler=sampler)
    got = []
    while len(got) < 6:  # past the first epoch's end
        for batch in loader:
            got.append(batch)
            if len(got) == 6:
                break
    want = chip_smoke.loader_rows(tokens, 6, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(np.int32))


# -- the master's goodput ledger (phases 4c and 4d) -------------------------------


def _master_lines(kill=True):
    """The exit summary of a port master's speed monitor that saw one
    worker's steps, a failure at 1010 and the next step at 1042 (or no
    failure), as the CLI would print it."""
    from dlrover_tpu_torch.master.local_master import goodput_summary
    from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor

    class Clock:
        t = 1000.0

        def __call__(self):
            return self.t

    clock = Clock()
    sm = SpeedMonitor(clock=clock)
    window = {"count": 1, "mean_s": 0.25, "p50_s": 0.25, "p95_s": 0.25,
              "max_s": 0.25}
    for step, t in ((1, 1001.0), (2, 1002.0)):
        sm.collect_global_step(step, t)
        sm.collect_step_digest(0, window, ts=t)
    if kill:
        sm.mark_downtime_start(ts=1010.0)
        sm.collect_global_step(3, 1042.0)
        sm.mark_downtime_end(ts=1042.0)
    clock.t = 1050.0
    return ["[INFO] [local_master.py:1:run] " + goodput_summary(sm),
            "[INFO] local master exiting: succeeded; checkpoint steps by "
            "node {0: 4}"]


def test_master_reading_parses_the_port_masters_summary():
    reading = chip_smoke.master_reading(_master_lines())
    assert reading["brackets"] == [[1010.0, 1042.0]]
    assert reading["downtime_s"] == 32.0 and reading["global_step"] == 3
    assert reading["stragglers"] == []
    assert reading["goodput"] == pytest.approx(1 - 32.0 / 49.0, abs=1e-6)
    cats = reading["attribution"]["categories"]
    assert reading["attribution"]["elapsed_wall_s"] == 49.0
    assert cats["productive"] == 0.5
    with pytest.raises(chip_smoke.SmokeFailure, match="no goodput summary"):
        chip_smoke.master_reading(["local master exiting: succeeded"])


def test_master_downtime_check():
    """One bracket inside [detection, second life's first step end],
    widened by the report interval: passes; none, two, one opened before
    the detection's slack or closed after the step's fails."""
    brackets = chip_smoke.master_reading(_master_lines())["brackets"]
    assert chip_smoke.check_master_downtime(brackets, 1008.0, 1041.0,
                                            15.0) == 32.0
    # the report's timestamps may trail the script's stamps by the slack
    assert chip_smoke.check_master_downtime([[994.0, 1055.0]], 1008.0,
                                            1041.0, 15.0) == 61.0
    no_kill = chip_smoke.master_reading(_master_lines(kill=False))
    assert no_kill["brackets"] == []
    for bad, match in (([], "0 downtime brackets"),
                       ([[1010.0, 1042.0], [1043.0, 1044.0]],
                        "2 downtime brackets"),
                       ([[992.0, 1042.0]], "not inside"),
                       ([[1010.0, 1057.0]], "not inside"),
                       ([[1042.0, 1010.0]], "not inside")):
        with pytest.raises(chip_smoke.SmokeFailure, match=match):
            chip_smoke.check_master_downtime(bad, 1008.0, 1041.0, 15.0)
    assert chip_smoke.report_interval() == 15.0


def test_master_gauges_check():
    from dlrover_tpu_torch.master.metrics import speed_monitor_lines
    from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor

    sm = SpeedMonitor(clock=lambda: 1050.0)
    sm.collect_global_step(2, 1000.0)
    gauges = chip_smoke.parse_metrics(
        "\n".join(speed_monitor_lines(sm) + [
            'dlrover_tpu_master_rpc_total{method="get",outcome="served"} 3']))
    assert gauges["dlrover_tpu_master_global_step"] == 2
    assert "dlrover_tpu_master_rpc_total" not in gauges
    reading = chip_smoke.master_reading(_master_lines())
    chip_smoke.check_master_gauges(gauges, reading)
    with pytest.raises(chip_smoke.SmokeFailure, match="never read"):
        chip_smoke.check_master_gauges({}, reading)
    with pytest.raises(chip_smoke.SmokeFailure, match="straggler"):
        chip_smoke.check_master_gauges(
            {**gauges, "dlrover_tpu_master_stragglers": 1.0}, reading)
    with pytest.raises(chip_smoke.SmokeFailure, match="straggler"):
        chip_smoke.check_master_gauges(gauges,
                                       {**reading, "stragglers": [0]})
    with pytest.raises(chip_smoke.SmokeFailure, match="goodput"):
        chip_smoke.check_master_gauges(
            {**gauges, "dlrover_tpu_master_goodput": 0.0}, reading)


# -- the four-card leg --------------------------------------------------------------


def _four_card_lives(nbytes=4_000_000):
    crc = {"params/w": 11, "opt/mu": 12, "step": 13}
    counts = {"flash_fwd": 16, "fused_ce_fwd": 2}
    shares = [nbytes // 4 + d for d in (1000, -1000, 500, -500)]
    shares[0] += 16  # the step scalars
    first = [{"rank": r, "crc": dict(crc), "counts": dict(counts),
              "stage": {"staged_bytes": shares[r]},
              "steps": [{"loss": x} for x in (12.5, 12.25, 12.0, 11.5)]}
             for r in range(4)]
    second = [{"rank": r, "crc": dict(crc), "counts": dict(counts),
               "restore": {"step": 2},
               "steps": [{"loss": x} for x in (12.0, 11.5)]}
              for r in range(4)]
    return first, second, nbytes


def test_four_card_checks_pass_on_good_lives():
    chip_smoke.check_four_card(*_four_card_lives())


@pytest.mark.parametrize("fault,match", [
    ("loss", "losses differ in the first"),
    ("resumed_loss", "losses differ in the second"),
    ("not_bitwise", "not bitwise"),
    ("full_replica", "staged .* bytes in all"),
    ("uneven_share", "not about 1/4"),
    ("restored_step", "restored steps"),
    ("restore_crc", "rank 2's restore"),
    ("staged_crc", "the state rank 1 staged"),
    ("no_launch", "never launched on rank 3 in the second"),
    ("missing_rank", "ranks"),
])
def test_four_card_checks_fail_on_each_fault(fault, match):
    first, second, nbytes = _four_card_lives()
    if fault == "loss":
        first[2]["steps"][1]["loss"] += 1e-6
    elif fault == "resumed_loss":
        second[1]["steps"][0]["loss"] += 1e-6
    elif fault == "not_bitwise":
        for r in second:
            r["steps"][1]["loss"] += 1e-7
    elif fault == "full_replica":
        for r in first:
            r["stage"]["staged_bytes"] = nbytes
    elif fault == "uneven_share":
        first[0]["stage"]["staged_bytes"] += nbytes // 10
        first[1]["stage"]["staged_bytes"] -= nbytes // 10
    elif fault == "restored_step":
        second[3]["restore"]["step"] = 0
    elif fault == "restore_crc":
        second[2]["crc"]["opt/mu"] += 1
    elif fault == "staged_crc":
        first[1]["crc"]["params/w"] += 1
    elif fault == "no_launch":
        second[3]["counts"]["fused_ce_fwd"] = 0
    elif fault == "missing_rank":
        second = second[:3]
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_four_card(first, second, nbytes)


# -- the step digest (phase 4c) and the control plane's recovery (phase 4e) -------


def _window(sample):
    return {"count": 1, "mean_s": sample, "p50_s": sample, "p95_s": sample,
            "max_s": sample, "input_wait_s": 0.0}


def test_digest_against_wall_check():
    """The device-time digest passes; the host share of a step (the
    digest before the fix), no sample, a sample 16 % off or a life with
    no step after its first fails."""
    walls = [9.8, 0.2381, 0.2352, 0.2360]
    windows = [None, _window(0.2349), _window(0.2336), _window(0.2344)]
    sample, wall = chip_smoke.check_digest_against_wall(windows, walls)
    assert (sample, wall) == (0.2344, 0.2360)
    # one sample (phase 4c's second life: steps 3-4, the first left out)
    assert chip_smoke.check_digest_against_wall(
        [None, _window(0.2349)], [9.8, 0.2381]) == (0.2349, 0.2381)
    for bad, steps, match in (
            ([None, _window(0.1152), _window(0.1149)], walls[:3],
             "not within 15%"),
            ([None, None], walls[:2], "no step report carried"),
            ([None, _window(0.2381 * 1.16)], walls[:2], "not within"),
            ([None, _window(0.2381 * 0.84)], walls[:2], "not within"),
            ([_window(0.2)], walls[:1], "no step after the first")):
        with pytest.raises(chip_smoke.SmokeFailure, match=match):
            chip_smoke.check_digest_against_wall(bad, steps)


def _relaunch_case():
    """A worker that trained the 16 ranges once, a master SIGKILLed at
    1001.6 after six step reports and its successor's exit summary, from
    real port speed monitors (the ledger exported, imported, the gap
    backdated to the last snapshot)."""
    from dlrover_tpu_torch.master.local_master import goodput_summary
    from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor

    class Clock:
        t = 1000.0

        def __call__(self):
            return self.t

    ranges = [(s, s + 2) for s in range(0, 32, 2)]
    file_crc = {r: 7000 + r[0] for r in ranges}
    shards = [[i + 1, s, e, file_crc[(s, e)]] for i, (s, e) in
              enumerate(ranges)]
    kill_t = 1001.6
    reports = [{"step": n, "ts": 1000.0 + 0.25 * n, "ok": True,
                "done_t": 1000.01 + 0.25 * n} for n in range(1, 7)]
    # step 7's report is built in the gap and gives up; step 8's reaches
    # the relaunched master on a retry
    reports.append({"step": 7, "ts": 1001.75, "ok": False, "done_t": 1004.8})
    reports += [{"step": n, "ts": 1004.9 + 0.25 * (n - 8), "ok": True,
                 "done_t": 1005.0 + 0.25 * (n - 8)} for n in range(8, 17)]
    clock = Clock()
    old = SpeedMonitor(clock=clock)
    for r in reports[:6]:
        old.collect_global_step(r["step"], r["ts"])
    clock.t = 1001.55
    state = old.export_state()
    clock.t = 1004.5
    new = SpeedMonitor(clock=clock)
    new.import_state(state)
    new.mark_downtime_start(ts=state["snapshot_time"])
    for r in reports[7:]:
        new.collect_global_step(r["step"], r["ts"])
        new.mark_downtime_end(ts=r["ts"])
    clock.t = 1008.0
    reading = chip_smoke.master_reading(
        ["[INFO] [local_master.py:1:run] " + goodput_summary(new)])
    life = {"shards": shards, "reports": reports}
    return life, ranges, file_crc, kill_t, reading, (1, 6)


def test_relaunch_check_passes():
    life, ranges, file_crc, kill_t, reading, resumed = _relaunch_case()
    assert reading["global_step"] == 16
    assert chip_smoke.check_relaunch(life, ranges, file_crc, kill_t, reading,
                                     resumed) == pytest.approx(1004.9
                                                               - 1001.55)
    line = "... local master resumed state: 1 datasets, global_step=6"
    assert chip_smoke.RESUMED.search(line).groups() == ("1", "6")


@pytest.mark.parametrize("fault, match", [
    ("twice", "trained twice"),
    ("missing", "never trained"),
    ("crc", "CRC32"),
    ("no_resume", "resumed None"),
    ("resume_zero", "resumed"),
    ("resume_ahead", "resumed"),
    ("two_datasets", "resumed"),
    ("final_step", "global step 15"),
    ("goodput", "goodput"),
    ("no_report_after", "no step report reached"),
    ("two_brackets", "2 downtime brackets"),
    ("late_start", "does not run from"),
    ("early_end", "does not run from"),
])
def test_relaunch_check_fails_on_each_fault(fault, match):
    life, ranges, file_crc, kill_t, reading, resumed = _relaunch_case()
    if fault == "twice":
        life["shards"].append(list(life["shards"][3]))
    elif fault == "missing":
        del life["shards"][10]
    elif fault == "crc":
        life["shards"][4][3] += 1
    elif fault == "no_resume":
        resumed = None
    elif fault == "resume_zero":
        resumed = (1, 0)
    elif fault == "resume_ahead":
        resumed = (1, 7)
    elif fault == "two_datasets":
        resumed = (2, 6)
    elif fault == "final_step":
        reading["global_step"] = 15
    elif fault == "goodput":
        reading["goodput"] = 0.0
    elif fault == "no_report_after":
        life["reports"] = life["reports"][:7]
    elif fault == "two_brackets":
        reading["brackets"].append([1006.0, 1006.5])
    elif fault == "late_start":
        reading["brackets"][0][0] = kill_t + 0.1
    elif fault == "early_end":
        # a report built before the kill closed the bracket
        reading["brackets"][0][1] = kill_t - 0.05
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_relaunch(life, ranges, file_crc, kill_t, reading,
                                  resumed)


def _hang_case():
    """The hang leg's two lives and what the port's master made of them:
    a real watchdog, rendezvous manager and speed monitor on a clock (the
    first life's last report at 1001.5, a sweep at 1045 past the 40 s
    window, the re-formed round, the second life's first report at
    1070.0), its declaration captured as the module logs it."""
    from dlrover_tpu_torch.master.local_master import goodput_summary
    from dlrover_tpu_torch.master.monitor import hang_watchdog
    from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor
    from dlrover_tpu_torch.master.rendezvous.manager import (
        ElasticTrainingRendezvousManager,
    )
    from dlrover_tpu_torch.master.rendezvous.net_topology import (
        NodeTopologyMeta,
    )

    class Clock:
        t = 990.0

        def __call__(self):
            return self.t

    clock = Clock()
    sm = SpeedMonitor(clock=clock)
    rdzv = ElasticTrainingRendezvousManager(clock=clock)
    rdzv.update_rdzv_params(min_nodes=1, max_nodes=1, node_unit=1)
    wd = hang_watchdog.HangWatchdog(speed_monitor=sm, rdzv_manager=rdzv,
                                    window_s=chip_smoke.HANG_WINDOW_S,
                                    clock=clock)
    declared = []
    real_warning = hang_watchdog.logger.warning
    hang_watchdog.logger.warning = lambda fmt, *a: declared.append(
        "[WARNING] [hang_watchdog.py:1:sweep] " + fmt % a)

    def seat():
        rdzv.join_rendezvous(0, 0, NodeTopologyMeta(
            node_id=0, node_rank=0, process_num=1, node_ip="127.0.0.1",
            node_port=1))
        rdzv.get_comm_world(0)
        wd.sweep()

    try:
        seat()
        sm.add_running_worker("worker", 0)
        first_reports = [{"step": 1, "ts": 1001.25, "ok": True},
                         {"step": 2, "ts": 1001.5, "ok": True}]
        for r in first_reports:
            sm.collect_global_step(r["step"], r["ts"])
        clock.t = 1045.0
        assert wd.sweep() is not None
        clock.t = 1058.0
        seat()  # the agent re-joins; the round re-forms
        second_reports = [{"step": n, "ts": 1070.0 + 0.25 * n, "ok": True}
                          for n in range(0, 4)]
        for r in second_reports:
            sm.mark_downtime_end(ts=r["ts"])
        clock.t = 1075.0
    finally:
        hang_watchdog.logger.warning = real_warning
    counts = {"flash_fwd": 16, "fused_ce_fwd": 2}
    first = {"steps": [{"loss": 11.936391830444336, "end_t": 1001.2},
                       {"loss": 11.89, "end_t": 1001.45}],
             "reports": first_reports, "stop": {"step": 2,
                                                "counts": dict(counts)},
             "end": None}
    second = {"steps": [{"loss": 11.936391830444336, "end_t": 1069.9}]
              + [{"loss": 11.8, "end_t": 1070.2 + 0.25 * i}
                 for i in range(chip_smoke.HANG_STEPS - 1)],
              "reports": second_reports, "stop": None,
              "end": {"counts": dict(counts)}}
    reading = chip_smoke.master_reading(
        ["[INFO] [local_master.py:1:run] " + goodput_summary(sm)])
    # the script's filter of the master's lines
    declared = [x for x in declared if "collective hang declared" in x]
    return first, second, declared, reading


def test_hang_check_passes():
    first, second, declared, reading = _hang_case()
    hang_s, bracket = chip_smoke.check_hang(first, second, declared, reading)
    assert hang_s == pytest.approx(1045.0 - 1001.5)
    assert bracket == [1001.5, 1070.0]


@pytest.mark.parametrize("fault, match", [
    ("none_declared", "declared 0 hangs"),
    ("two_declared", "declared 2 hangs"),
    ("silent", "silent members"),
    ("not_stopped", "stopped None"),
    ("short_second_life", f"trained {chip_smoke.HANG_STEPS - 1} of "
                          f"{chip_smoke.HANG_STEPS}"),
    ("first_life_never_stopped", "trained 24 steps and stopped"),
    ("step1_loss", "not bitwise"),
    ("hang_short", "outside"),
    ("hang_long", "outside"),
    ("bracket_start", "not one from the last"),
    ("bracket_end", "not one from the last"),
    ("two_brackets", "not one from the last"),
    ("first_launch", "never launched in the first"),
    ("second_launch", "never launched in the second"),
])
def test_hang_check_fails_on_each_fault(fault, match):
    first, second, declared, reading = _hang_case()
    cats = reading["attribution"]["categories"]
    if fault == "none_declared":
        declared = []
    elif fault == "two_declared":
        declared = declared * 2
    elif fault == "silent":
        declared = [declared[0].replace("silent members none",
                                        "silent members [0]")]
    elif fault == "not_stopped":
        first["stop"] = None
    elif fault == "short_second_life":
        second["steps"] = second["steps"][:-1]
    elif fault == "first_life_never_stopped":
        first["steps"] = first["steps"] * (chip_smoke.HANG_STEPS // 2)
    elif fault == "step1_loss":
        second["steps"][0]["loss"] = 11.936391830444338
    elif fault == "hang_short":
        cats["collective_hang"] = chip_smoke.HANG_WINDOW_S - 0.5
    elif fault == "hang_long":
        cats["collective_hang"] = 1.25 * chip_smoke.HANG_WINDOW_S + 1.5
    elif fault == "bracket_start":
        reading["brackets"][0][0] = 1001.25  # not the last progress stamp
    elif fault == "bracket_end":
        reading["brackets"][0][1] = 1075.0
    elif fault == "two_brackets":
        reading["brackets"].append([1072.0, 1073.0])
    elif fault == "first_launch":
        first["stop"]["counts"]["fused_ce_fwd"] = 0
    elif fault == "second_launch":
        second["end"]["counts"]["flash_fwd"] = 0
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_hang(first, second, declared, reading)


def test_hang_lives_split_the_one_log(tmp_path, monkeypatch):
    """Both lives of the hang leg's worker write one log (a re-formed round
    restarts it under the same restart count): split at the life records;
    one life alone fails."""
    import json

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir

    job = "chip-smoke-hang-lives"
    os.makedirs(agent_log_dir(job, 0))
    path = os.path.join(agent_log_dir(job, 0), "worker-0-restart0.log")

    def rec(kind, **kw):
        return "DATA_CHILD_JSON " + json.dumps({"kind": kind, **kw}) + "\n"

    first = [rec("life", first=True), rec("step", loss=1.5),
             "step 1 loss 1.5000 (9.0s)\n", rec("report", ts=1.0, ok=True),
             rec("stop", step=1, counts={})]
    second = [rec("life", first=False), rec("step", loss=1.5),
              rec("report", ts=9.0, ok=True), rec("end", counts={})]
    with open(path, "w") as f:
        f.writelines(first + second)
    one, two = chip_smoke._hang_lives(job)
    assert one["stop"]["step"] == 1 and one["end"] is None
    assert [s["loss"] for s in one["steps"]] == [1.5]
    assert two["reports"][0]["ts"] == 9.0 and two["end"] is not None
    with open(path, "w") as f:
        f.writelines(first)
    with pytest.raises(chip_smoke.SmokeFailure, match="lived 1 lives"):
        chip_smoke._hang_lives(job)


# -- the planner in phase 4e's relaunch leg ---------------------------------------


def _planner_docs(sample=0.23, n_before=3, n_after=2):
    """The planner documents of phase 4e's two masters, from real port
    planners over one worker's digests: the first decides ``n_before``
    times, its successor imports its export (through JSON, as the state
    store does) and decides ``n_after`` times; the /metrics body of the
    successor; the digest windows the worker reported."""
    import json
    import types

    from dlrover_tpu_torch.brain.planner import GoodputPlanner
    from dlrover_tpu_torch.master import metrics as mm
    from dlrover_tpu_torch.master.monitor.speed_monitor import SpeedMonitor

    clock = [1000.0]
    sm = SpeedMonitor(clock=lambda: clock[0])
    rdzv = types.SimpleNamespace(world_snapshot=lambda: types.SimpleNamespace(
        latest_world=(0,), num_waiting=0, rdzv_nodes={}))
    windows = [_window(sample * (1 + 0.01 * (i % 3))) for i in range(6)]

    def planner():
        return GoodputPlanner(speed_monitor=sm, rdzv_manager=rdzv,
                              clock=lambda: clock[0], decide_interval_s=1.0)

    first = planner()
    for i in range(n_before):
        sm.collect_global_step(i + 1, clock[0])
        sm.collect_step_digest(0, windows[i], ts=clock[0])
        clock[0] += 1.0
        first.sweep()
    before = json.loads(json.dumps(first.export_state()))
    second = planner()
    second.import_state(before)
    for i in range(n_after):
        clock[0] += 1.0
        second.sweep()
    after = json.loads(json.dumps(second.export_state()))
    server = mm.MasterMetricsServer(port=0)
    server.add_provider(second.prometheus_lines)
    text = "\n".join(second.prometheus_lines())
    return before, after, text, windows


def test_relaunch_planner_check_passes():
    before, after, text, windows = _planner_docs()
    p50, median, n0, n1 = chip_smoke.check_relaunch_planner(
        before, after, text, windows)
    assert (n0, n1) == (3, 5)
    assert median == pytest.approx(0.23 * 1.01)
    assert abs(p50 - median) <= chip_smoke.PLANNER_STEP_TOL * median


@pytest.mark.parametrize("fault,match", [
    ("none_before", "no decision before the kill"),
    ("none_after", "no decision after the relaunch"),
    ("not_continued", "does not continue"),
    ("resize", "more than HOLD"),
    ("executed", "more than HOLD"),
    ("no_metrics", "no planner lines"),
    ("no_p50", "observed a step p50"),
    ("no_samples", "observed a step p50"),
    ("p50_off", "not within"),
])
def test_relaunch_planner_check_fails_on_each_fault(fault, match):
    before, after, text, windows = _planner_docs()
    if fault == "none_before":
        before = None
    elif fault == "none_after":
        _, after, _, _ = _planner_docs(n_after=0)
    elif fault == "not_continued":
        after["ledger"][0]["ts"] += 1.0
    elif fault == "resize":
        after["ledger"][-1]["verdict"] = "resize"
    elif fault == "executed":
        after["executed"] = [{"ts": 1.0, "target": "dp2",
                              "target_world": 2}]
    elif fault == "no_metrics":
        text = "dlrover_tpu_master_goodput 0.9"
    elif fault == "no_p50":
        for d in before["ledger"] + after["ledger"]:
            d["inputs"]["step_p50_s"] = 0.0
    elif fault == "no_samples":
        windows = [None] * 6
    elif fault == "p50_off":
        windows = [_window(0.3)] * 6
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_relaunch_planner(before, after, text, windows)


def test_planner_doc_reads_the_masters_file_state(tmp_path, monkeypatch):
    """``load_planner_doc`` reads what a port master's state manager wrote
    under ``DLROVER_TPU_STATE_DIR`` for its job (None before)."""
    from dlrover_tpu_torch.master.state_store import (
        MasterStateManager, create_state_backend)

    monkeypatch.setenv("DLROVER_TPU_STATE_BACKEND", "file")
    monkeypatch.setenv("DLROVER_TPU_STATE_DIR", str(tmp_path))
    assert chip_smoke.load_planner_doc(str(tmp_path), "j") is None
    before, _, _, _ = _planner_docs()
    MasterStateManager(create_state_backend("j")).save_planner(before)
    assert chip_smoke.load_planner_doc(str(tmp_path), "j") == before


# -- the four-card scale-out leg --------------------------------------------------


def _scale_case():
    """A scale-out that went right, as the leg reads it: node 0's two dp2
    lives up to step 9 (the hint armed after the execution at 1014), node
    1's start at 1006 and its agent's detection at 1019, the persisted
    step 8 restored on all four dp4 ranks, every step's rows the loader's
    order's (``crc_of`` stands for their CRC32), and the planner's
    ledger."""
    counts = {"flash_fwd": 4, "fused_ce_fwd": 2}
    pieces = {"params#s0": 11, "params#s1": 12, "opt.mu#s0": 13}

    def crc_of(step, rank, world):
        return step * 100 + rank * 10 + world

    def step(n, rank, world, t, hint="", loss=None):
        return {"step": n, "loss": 10.0 - 0.1 * n if loss is None else loss,
                "seconds": 0.5, "end_t": t, "crc": crc_of(n, rank, world),
                "hint": hint, "counts": dict(counts)}

    firsts = [{"life": {"rank": r, "world": 2, "start": 0, "restore": None},
               "steps": [step(n, r, 2, 1000.0 + 2 * n,
                              "dp4" if 1000.0 + 2 * n > 1014.0 else "")
                         for n in range(1, 10)], "end": None}
              for r in range(2)]
    seconds = [{"life": {"rank": r, "world": 4, "start": 8,
                         "start_t": 1030.0, "pieces": dict(pieces),
                         "restore": {"step": 8, "tier": "disk"}},
                "steps": [step(n, r, 4, 1040.0 + n,
                               loss=10.0 - 0.1 * n + (2e-7 if n == 9 else 0))
                          for n in range(9, 9 + chip_smoke.SCALE_AFTER)],
                "end": {"counts": dict(counts)}}
               for r in range(4)]
    ledger = [{"verdict": "hold", "reason": "no_signal", "target": "",
               "target_world": 0, "current_world": 1},
              {"verdict": "hold", "reason": "hysteresis:1/2",
               "target": "dp2", "target_world": 2, "current_world": 1},
              {"verdict": "resize", "reason": "payback", "target": "dp2",
               "target_world": 2, "current_world": 1},
              {"verdict": "hold", "reason": "cooldown", "target": "",
               "target_world": 0, "current_world": 2}]
    executed = [{"ts": 1014.0, "target": "dp2", "target_world": 2}]
    return dict(firsts=firsts, seconds=seconds, ledger=ledger,
                executed=executed, join_t=1006.0, seen_t=1019.0,
                pieces=pieces, expected_crc=crc_of)


def test_scale_out_check_passes():
    assert chip_smoke.check_scale_out(**_scale_case()) == 8


@pytest.mark.parametrize("fault,match", [
    ("two_resizes", "2 RESIZEs"),
    ("no_resize", "0 RESIZEs"),
    ("wrong_target", "RESIZE was"),
    ("no_streak", "before the RESIZE"),
    ("not_executed", "executed plans"),
    ("executed_twice", "executed plans"),
    ("no_wait", "steps between node 1's start"),
    ("no_hint", "hints"),
    ("early_hint", "hints"),
    ("early_reform", "re-formed round"),
    ("three_ranks", "dp4 lives"),
    ("restored_apart", "restored steps"),
    ("piece_crc", "restored pieces"),
    ("rows", "other rows"),
    ("dp4_losses", "losses differ"),
    ("continuity", "not within"),
    ("no_launch_dp2", "never launched on rank 1 in the dp2"),
    ("no_launch_dp4", "never launched on rank 2 in the dp4"),
    ("dp4_steps", "dp4 steps"),
])
def test_scale_out_check_fails_on_each_fault(fault, match):
    case = _scale_case()
    firsts, seconds, ledger = case["firsts"], case["seconds"], case["ledger"]
    if fault == "two_resizes":
        ledger[3]["verdict"] = "resize"
    elif fault == "no_resize":
        ledger[2]["verdict"] = "hold"
    elif fault == "wrong_target":
        ledger[2]["target"] = "dp3"
    elif fault == "no_streak":
        ledger[1]["reason"] = "no_paying_candidate"
    elif fault == "not_executed":
        case["executed"] = []
    elif fault == "executed_twice":
        case["executed"] = case["executed"] * 2
    elif fault == "no_wait":
        case["seen_t"] = 1009.0
    elif fault == "no_hint":
        firsts[0]["steps"][-1]["hint"] = ""
    elif fault == "early_hint":
        firsts[1]["steps"][0]["hint"] = "dp4"
    elif fault == "early_reform":
        seconds[3]["life"]["start_t"] = 1013.0
    elif fault == "three_ranks":
        case["seconds"] = seconds[:3]
    elif fault == "restored_apart":
        seconds[2]["life"]["start"] = 7
    elif fault == "piece_crc":
        seconds[1]["life"]["pieces"]["opt.mu#s0"] += 1
    elif fault == "rows":
        firsts[1]["steps"][4]["crc"] += 1
    elif fault == "dp4_losses":
        seconds[3]["steps"][1]["loss"] += 1e-6
    elif fault == "continuity":
        for x in seconds:
            x["steps"][0]["loss"] += 1e-3
    elif fault == "no_launch_dp2":
        firsts[1]["steps"][-1]["counts"]["flash_fwd"] = 0
    elif fault == "no_launch_dp4":
        seconds[2]["end"]["counts"]["fused_ce_fwd"] = 0
    elif fault == "dp4_steps":
        for x in seconds:
            x["steps"] = x["steps"][:-1]
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_scale_out(**case)


@pytest.mark.parametrize("world", [2, 4])
def test_scale_rows_equal_the_port_loaders_rows(tmp_path, world):
    """``scale_rows_crc`` (the script's own replica of a rank's rows) equals
    the CRC32 of the rows the port's token-file flow gives each rank at dp2
    and dp4, from the epoch's start and from a sidecar's position."""
    import types
    import zlib

    import numpy as np

    from dlrover_tpu_torch.run import llama_pretrain

    path = str(tmp_path / "corpus.bin")
    tokens = chip_smoke.write_corpus(path, seed=3, records=32, seq=16,
                                     vocab=300)
    args = llama_pretrain.parse_args([
        "--device", "cpu", "--model", "tiny", "--seq", "16",
        "--micro-batch", "1", "--global-batch", "8", "--data", path,
        "--data-dtype", "uint32", "--ckpt-dir", str(tmp_path / "ck")])
    cfg = types.SimpleNamespace(vocab_size=512)
    llama_pretrain.write_sidecar(llama_pretrain.sidecar_path(
        args.ckpt_dir, 0), 2, {"epoch": 0, "completed_samples": 16})
    for rank in range(world):
        trainer = types.SimpleNamespace(
            step_batch_shape=(8 // world, world), dp=world,
            rows=slice(rank, rank + 1))
        for restored, first in ((None, 1), (2, 3)):
            batches, _, _ = llama_pretrain.open_data(
                args, cfg, trainer, 16, "cpu", restored, log=lambda m: None)
            for step in range(first, first + 3):
                got = next(batches).numpy().astype(np.int64)
                assert zlib.crc32(got.tobytes()) == chip_smoke.scale_rows_crc(
                    tokens, step, rank, world, global_batch=8)


def test_piece_crcs_cover_each_pieces_rows():
    """``piece_crcs`` takes each persisted piece's rows (``index``) of its
    leaf by the flattened state's names: equal to the CRC32 of the numpy
    slices, the scalars whole."""
    import zlib

    import numpy as np
    import torch

    from dlrover_tpu_torch.checkpoint.shm_handler import (
        TensorMeta, flatten_state)

    w = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    state = {"params": {"w": w}, "step": 3}
    names = [leaf.name for leaf in flatten_state(state)]
    wname = next(n for n in names if "w" in n and "step" not in n)
    sname = next(n for n in names if "step" in n)
    pieces = [
        TensorMeta(f"{wname}#s0", "float32", (3, 4), 0, 48, (6, 4),
                   ((0, 3), (0, 4)), 0),
        TensorMeta(f"{wname}#s1", "float32", (3, 4), 0, 48, (6, 4),
                   ((3, 6), (0, 4)), 0),
        TensorMeta(sname, "int32", (), 0, 4, (), (), 0),
    ]
    got = chip_smoke.piece_crcs(torch, state, pieces)
    full = w.numpy()
    assert got[f"{wname}#s0"] == zlib.crc32(full[:3].tobytes())
    assert got[f"{wname}#s1"] == zlib.crc32(full[3:].tobytes())
    step_leaf = next(leaf for leaf in flatten_state(state)
                     if leaf.name == sname)
    from dlrover_tpu_torch.checkpoint.shm_handler import as_bytes

    assert got[sname] == zlib.crc32(as_bytes(step_leaf.value).numpy())


# -- the diagnosis legs: the action sequence, stuck_at, timer vs digest ------

STUCK = "timed_step (llama_pretrain.py:156)"


def _actions(nodes=(0,), stuck=STUCK, slowest="0"):
    tail = f" [slowest node {slowest}]" if slowest is not None else ""
    return ([("CollectHangDump", n, "training_hang") for n in nodes]
            + [("RestartWorker", n, f"training_hang @ {stuck}{tail}")
               for n in nodes])


def test_enqueued_actions_read_the_masters_log():
    """The port's master logs each action it enqueues; the script reads
    them back in order, from the manager's own log lines."""
    from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
    from dlrover_tpu_torch.common import messages as msg
    from dlrover_tpu_torch.common.log import logger
    from dlrover_tpu_torch.common.node import Node
    from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager
    from dlrover_tpu_torch.master.node.job_context import JobContext

    ctx = JobContext()
    for i in (0, 1):
        ctx.update_node(Node(NodeType.WORKER, i, status=NodeStatus.RUNNING))
    mgr = DiagnosisManager(interval_secs=3600, job_context=ctx)
    stack = ('Current thread 0x1 (most recent call first):\n'
             '  File "/x/llama_pretrain.py", line 156 in timed_step\n'
             '  File "/x/llama_pretrain.py", line 320 in run\n')
    lines = []

    class Sink:
        def write(self, text):
            lines.extend(text.splitlines())

        def flush(self):
            pass

    import logging
    handler = logging.StreamHandler(Sink())
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(levelname)s] %(message)s"))
    logger.addHandler(handler)
    try:
        for i in (0, 1):
            mgr.collect_diagnosis_data(msg.DiagnosisReportData(
                data_cls="TpuMetricsRecord", node_id=i,
                data_content='{"hang": true, "mfu": %s}' % (0.2 + i / 10)))
        mgr.diagnose_once()
        for i in (0, 1):
            mgr.collect_diagnosis_data(msg.DiagnosisReportData(
                data_cls="HangDumpRecord", node_id=i, data_content=(
                    '{"reason": "master_request", "pending": {}, "stacks": '
                    '{"%d": %s}}' % (100 + i, __import__("json").dumps(
                        stack)))))
        mgr.diagnose_once()
    finally:
        logger.removeHandler(handler)
    actions = chip_smoke.enqueued_actions(lines)
    assert chip_smoke.check_action_sequence(actions, [0, 1]) == STUCK
    assert all(chip_smoke.log_epoch(x) > 0 for x in lines
               if "enqueued" in x)
    assert sum(bool(chip_smoke.RESTART_ALL.search(x)) for x in lines) == 1
    with pytest.raises(chip_smoke.SmokeFailure, match="did not cause"):
        chip_smoke.check_no_actions(lines, "test leg")
    chip_smoke.check_no_actions([x for x in lines if "enqueued" not in x],
                                "test leg")


def test_action_sequence_check_passes():
    assert chip_smoke.check_action_sequence(_actions(), [0]) == STUCK
    assert chip_smoke.check_action_sequence(
        _actions((0, 1), slowest=None), [0, 1]) == STUCK


@pytest.mark.parametrize("actions,nodes,match", [
    (_actions()[:1], [0], "not a dump and a restart"),
    (_actions() + [("RestartWorker", 0, "hardware")], [0],
     "not a dump and a"),
    (list(reversed(_actions())), [0], "not one hang dump a node"),
    ([("CollectHangDump", 1, "training_hang")] + _actions()[1:], [0],
     "not one hang dump a node"),
    (_actions()[:1] + [("RelaunchWorker", 0, "hardware")], [0],
     "not followed by one restart"),
    (_actions((0, 1))[:2] + [("RestartWorker", 0, "training_hang @ a (b:1)"),
                            ("RestartWorker", 1, "training_hang @ c (d:2)")],
     [0, 1], "differ in reason"),
    (_actions()[:1] + [("RestartWorker", 0, "training_hang")], [0],
     "names no stuck_at"),
])
def test_action_sequence_check_fails_on_each_fault(actions, nodes, match):
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_action_sequence(actions, nodes)


HOT = ["<module> (chip_smoke.py:5000)", "data_child (chip_smoke.py:2300)",
       "_diag_child (chip_smoke.py:2400)", "run (llama_pretrain.py:320)",
       "timed (chip_smoke.py:2380)", STUCK]
LEAF = r"timed_step \(llama_pretrain\.py:\d+\)$"
THROUGH = r"run \(llama_pretrain\.py:\d+\)$"


def test_stuck_at_check_passes():
    chip_smoke.check_stuck_at(STUCK, HOT, LEAF, THROUGH)


@pytest.mark.parametrize("stuck,hot,match", [
    ("step (optim.py:95)", HOT[:-1] + ["step (optim.py:95)"], "is not the "
     "wait"),
    (STUCK, HOT[:-1], "is not the dumped stacks' leaf"),
    (STUCK, [], "is not the dumped stacks' leaf"),
    (STUCK, [HOT[0], STUCK], "passes through no"),
])
def test_stuck_at_check_fails_on_each_fault(stuck, hot, match):
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_stuck_at(stuck, hot, LEAF, THROUGH)


def _scrape(total, us_sum, mfu):
    return {"mfu": mfu, "programs": {"train_step": {
        "execute_total": total, "execute_us_sum": us_sum}}}


FLOPS = 6.0 * 1_923_125_248 * 4096


def _timer_case(n=9, step_s=0.2330, timer_s=0.2331, mfu=None):
    samples = [step_s] * n
    mfu = FLOPS / step_s / chip_smoke.PEAK_BF16_FLOPS if mfu is None else mfu
    before = _scrape(2, 17_800_000, 0.1)
    after = _scrape(2 + n, 17_800_000 + n * timer_s * 1e6, mfu)
    return before, after, samples


def test_timer_against_digest_check_passes():
    before, after, samples = _timer_case()
    timer_s, digest_s, gauge, mfu = chip_smoke.check_timer_against_digest(
        before, after, samples, FLOPS)
    assert timer_s == pytest.approx(0.2331)
    assert digest_s == pytest.approx(0.2330)
    assert gauge == pytest.approx(mfu)


@pytest.mark.parametrize("case,match", [
    (dict(n=7), "at least 8 needed"),
    (dict(timer_s=0.2330 * 1.06), "is not within 5%"),
    (dict(timer_s=0.2330 * 0.94), "is not within 5%"),
    (dict(mfu=0.5), "MFU gauge"),
    (dict(mfu=0.0), "MFU gauge"),
])
def test_timer_against_digest_check_fails_on_each_fault(case, match):
    before, after, samples = _timer_case(**case)
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_timer_against_digest(before, after, samples, FLOPS)


def test_timer_against_digest_counts_must_agree():
    before, after, samples = _timer_case()
    with pytest.raises(chip_smoke.SmokeFailure, match="digest took 8"):
        chip_smoke.check_timer_against_digest(before, after, samples[1:],
                                              FLOPS)


def _reduce_window(step, before, after):
    return {"step": step, "before": {"count": before[0], "us_sum": before[1]},
            "after": {"count": after[0], "us_sum": after[1]}}


def _kill_life(grads=12, ms=(32.1, 32.4), span=(32.6, 32.9), count=None):
    """One rank of the kill leg's first life as its JSON carries it."""
    windows, base = [], (20, 900_000.0)
    for step, t in zip(chip_smoke.FOUR_CARD_REDUCE_STEPS, ms):
        n = grads if count is None else count
        windows.append(_reduce_window(step, base, (base[0] + n,
                                            base[1] + t * 1e3)))
        base = (base[0] + n + 3, base[1] + t * 1e3 + 500.0)
    return {"rank": 0, "grad_all_reduces": grads, "reduce_windows": windows,
            "steps": [{"step": s, "reduce_ms": m} for s, m in
                      zip(chip_smoke.FOUR_CARD_REDUCE_STEPS, span)],
            "timer": {"programs": {"nccl:AllReduce": {
                "execute_total": 61.0, "execute_us_sum": 1.9e6,
                "program_bytes": 4.0}}}}


def test_reduce_window_check_passes():
    [x] = chip_smoke.check_nccl_programs([_kill_life()])
    assert x["programs"]["nccl:AllReduce"]["count"] == 61
    assert [w[:2] for w in x["windows"]] == [(3, 12), (4, 12)]
    assert x["windows"][0][2] == pytest.approx(32.1)
    assert x["windows"][0][3] == pytest.approx(32.6)


@pytest.mark.parametrize("case,match", [
    # a host wait from each call to its poll: the kernels queued ahead
    (dict(ms=(32.6 * 1.02, 32.4)), r"not within \[0.5, 1.01\]"),
    (dict(ms=(32.1, 32.9 * 6)), r"not within \[0.5, 1.01\]"),
    (dict(ms=(32.6 * 0.49, 32.4)), r"not within \[0.5, 1.01\]"),
    (dict(count=13), "ended 13 all-reduces"),
    (dict(count=11), "ended 11 all-reduces"),
])
def test_reduce_window_check_fails_on_each_fault(case, match):
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.check_nccl_programs([_kill_life(**case)])


def test_nccl_programs_check_needs_the_timer_and_both_windows():
    life = _kill_life()
    life["timer"] = {"programs": {"train_step": {}}}
    with pytest.raises(chip_smoke.SmokeFailure, match="no nccl:AllReduce"):
        chip_smoke.check_nccl_programs([life])
    life = _kill_life()
    del life["reduce_windows"][1]["after"]
    with pytest.raises(chip_smoke.SmokeFailure, match="in steps"):
        chip_smoke.check_nccl_programs([life])
    life = _kill_life()
    life["reduce_windows"].pop()
    with pytest.raises(chip_smoke.SmokeFailure, match=r"in steps \[3\]"):
        chip_smoke.check_nccl_programs([life])
