"""run/profile_step.py's summary over a made-up device timeline, on the CPU:
kernels go to the scope whose span holds their start, and each of the
port's kernels reports its device ms and launches a step and its ms a
launch (what PERF.md's in-step column reads)."""

import pytest
from torch.autograd import DeviceType

from dlrover_tpu_torch.run import profile_step


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Event:
    def __init__(self, name, start, end):
        self.name = name
        self.device_type = DeviceType.CUDA
        self.time_range = _Range(start, end)
        self.is_user_annotation = False


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


FWD = "void (anonymous namespace)::flash_fwd_kernel<128>(CUtensorMap_st, int)"
DW = "(anonymous namespace)::fused_ce_bwd_dw_kernel(CUtensorMap_st, float*)"


def test_port_kernels_per_step_and_per_launch():
    events = [
        # two steps' worth: one scope span each, kernels in microseconds
        _Event("attention_fwd", 0, 100), _Event(FWD, 10, 40),
        _Event("attention_fwd", 1000, 1100), _Event(FWD, 1010, 1070),
        _Event("fused_ce_bwd", 200, 600), _Event(DW, 210, 260),
        _Event(DW, 300, 380), _Event(DW, 400, 430),
        _Event("elementwise_kernel", 700, 720),
    ]
    summary = profile_step.summarize(_Prof(events), steps=2, wall_s=2e-3)
    port = summary["port_kernels"]
    assert set(port) == {"flash_fwd_kernel<128>", "fused_ce_bwd_dw_kernel"}
    fwd, dw = port["flash_fwd_kernel<128>"], port["fused_ce_bwd_dw_kernel"]
    assert fwd["launches_per_step"] == 1.0
    assert fwd["ms_per_step"] == pytest.approx(0.045)
    assert fwd["ms_per_launch"] == pytest.approx(0.045)
    assert dw["launches_per_step"] == 1.5
    assert dw["ms_per_step"] == pytest.approx(0.08)
    assert dw["ms_per_launch"] == pytest.approx(160 / 3 / 1e3)
    scopes = summary["scopes_ms_per_step"]
    assert scopes["attention_fwd"] == pytest.approx(0.045)
    assert scopes["fused_ce_bwd"] == pytest.approx(0.08)
    assert scopes["rest of the step"] == pytest.approx(0.01)
