from gastx_torch.utils.logging import MetricLogger, export_training_curves
from gastx_torch.utils.profiling import (benchmark, capture_trace,
                                         flops_estimate, trace)

__all__ = ["MetricLogger", "benchmark", "capture_trace",
           "export_training_curves", "flops_estimate", "trace"]
