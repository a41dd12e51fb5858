"""Diagnosis: inference-chain reasoning over runtime observations (the
port's own copy of dlrover_tpu/diagnosis/), and the worker-log classifier."""

from dlrover_tpu_torch.diagnosis import actions
from dlrover_tpu_torch.diagnosis.data import (
    DiagnosisData,
    DiagnosisDataManager,
    DiagnosisDataType,
    TpuMetricsRecord,
    TrainingLogRecord,
)
from dlrover_tpu_torch.diagnosis.inference import (
    Inference,
    InferenceAttribute,
    InferenceChain,
    InferenceDescription,
    InferenceName,
    InferenceOperator,
)

__all__ = [
    "actions",
    "DiagnosisData",
    "DiagnosisDataManager",
    "DiagnosisDataType",
    "TpuMetricsRecord",
    "TrainingLogRecord",
    "Inference",
    "InferenceAttribute",
    "InferenceChain",
    "InferenceDescription",
    "InferenceName",
    "InferenceOperator",
]
