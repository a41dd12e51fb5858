from dlrover_tpu_torch.master.diagnosis.manager import DiagnosisManager

__all__ = ["DiagnosisManager"]
