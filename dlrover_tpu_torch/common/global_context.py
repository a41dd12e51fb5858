"""Runtime config context for the master: the port's own copy of
dlrover_tpu/common/global_context.py (``MasterConfigContext``).

Every field is runtime-mutable with type coercion, so an operator can
retune a live master (timeouts, the rendezvous last-call window, the
auto-scaler's warmup and cadence, the hang check's silence) without a
restart. Consumers read attributes each time they need a value, no
caching, which is what makes runtime mutation take effect.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from dlrover_tpu_torch.common.log import logger


class MasterConfigContext:
    """Thread-safe, runtime-mutable master tunables.

    One instance per job, owned by
    :class:`~dlrover_tpu_torch.master.job_container.JobContainer`.
    Consumers hold the instance and re-read attributes per use: that
    per-use read is what makes runtime mutation land.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # Every field here has a live consumer that re-reads it per use;
        # the JAX package's other fields wait for theirs (the dist job
        # manager).
        # -- autoscaling (job_auto_scaler) -----------------------------------
        self.auto_worker_enabled = True
        self.seconds_to_autoscale_worker = 90.0  # warmup before 1st cycle
        self.seconds_interval_to_optimize = 300.0
        self.sample_count_to_adjust_worker = 5
        # -- rendezvous (rendezvous.manager, re-read per completion check) ---
        # last-call window past min_nodes before the round closes
        self.rdzv_waiting_timeout = 60.0
        # -- hang detection (diagnosis CheckTrainingHangOperator) ------------
        self.seconds_hang_threshold = 300.0  # step-report silence to confirm
        # -- the diagnosis manager's observe loop (re-read each cycle) -------
        self.seconds_diagnosis_interval = 60.0

    # ------------------------------------------------------------------
    def update(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """Apply ``{field: value}`` with type coercion to each field's
        current type; unknown keys are ignored with a warning. Returns the
        applied subset."""
        applied: Dict[str, Any] = {}
        with self._lock:
            for key, value in values.items():
                if key.startswith("_") or not hasattr(self, key):
                    logger.warning("unknown master config key %r ignored", key)
                    continue
                current = getattr(self, key)
                try:
                    if isinstance(current, bool):
                        # bool("False") is True — parse strings explicitly
                        coerced = _parse_bool(value)
                    else:
                        coerced = type(current)(value)
                except (TypeError, ValueError):
                    logger.warning(
                        "master config %s=%r not coercible to %s; ignored",
                        key, value, type(current).__name__,
                    )
                    continue
                setattr(self, key, coerced)
                applied[key] = coerced
        if applied:
            logger.info("master config updated: %s", applied)
        return applied


def parse_bool(value: Any) -> bool:
    """Strict boolean from loosely-typed input: ``"false"``/``"0"`` parse
    False, unrecognized strings raise rather than silently coercing True."""
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered in ("false", "0", "no", "off", ""):
            return False
        if lowered in ("true", "1", "yes", "on"):
            return True
        raise ValueError(f"not a boolean: {value!r}")
    return bool(value)


_parse_bool = parse_bool  # internal callers predate the public name

