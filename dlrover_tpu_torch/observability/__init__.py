"""The goodput observatory's worker half, as far as the port has it: the
port's own copy of dlrover_tpu/observability's windowed step-time digests
(``digest.py``), which ride the step report to the master's straggler
detector and lost-time attribution (``master/monitor/``). The JAX
package's typed-span trace ring waits for the tracing slice (ROADMAP.md).
"""

from dlrover_tpu_torch.observability.digest import StepTimeDigest  # noqa: F401
