from gastx_torch.utils.logging import MetricLogger, export_training_curves

__all__ = ["MetricLogger", "export_training_curves"]
