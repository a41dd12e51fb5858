"""The profiler: the device timer (tpu_timer.py over csrc/cuda_hook.cc),
the hang dumper and the stack trie. The port's own copy of the part of
dlrover_tpu/profiler/ ported so far; the comm ledger, kernel ledger, trace
ring, py_tracing and the stack sampler wait for ROADMAP item 13."""

from dlrover_tpu_torch.profiler.tpu_timer import (  # noqa: F401
    TpuTimerMetricsSource,
    build_native,
    dump_timeline,
    interposer_env,
    native_build_dir,
    scrape_metrics,
)
from dlrover_tpu_torch.profiler.hang_dump import (  # noqa: F401
    HangDumper,
    install_stack_dump_handler,
)
from dlrover_tpu_torch.profiler.analysis import StackTrie  # noqa: F401
