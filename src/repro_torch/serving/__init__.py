from repro_torch.serving import cache
from repro_torch.serving.engine import decode_step, generate, prefill
from repro_torch.serving.lm_driver import GenerateDriver
from repro_torch.serving.metrics import (GroupMetrics, LatencyWindow,
                                         MetricsRegistry)
from repro_torch.serving.scheduler import (BatchPolicy, BatchScheduler,
                                           QueueFullError)
from repro_torch.serving.stencil_driver import StencilDriver

__all__ = [
    "BatchPolicy", "BatchScheduler", "GenerateDriver", "GroupMetrics",
    "LatencyWindow", "MetricsRegistry", "QueueFullError", "StencilDriver",
    "cache",
    "decode_step", "generate", "prefill",
]
