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
