"""repro_torch.serving — the batched inference server of the port (port of
``repro.serving``: the server, its adapters, double-buffered weights, the
open-loop load generator and the ``repro.serve/v1`` metrics document).

``python -m repro_torch.serving.serve_llm`` serves an LM end to end. The
checkpoint watcher and the train+serve CLI (``python -m repro.serving``)
wait for the port's checkpoint slice (ROADMAP Queue 1, slice F).
"""
from __future__ import annotations

from repro_torch.serving.hot_swap import WeightBuffers
from repro_torch.serving.loadgen import LoadGenerator
from repro_torch.serving.metrics import (SCHEMA_VERSION, ServingMetrics,
                                         load_metrics, validate_metrics)
from repro_torch.serving.server import (ClassifierAdapter, InferenceServer,
                                        LMAdapter)

__all__ = [
    "WeightBuffers", "LoadGenerator", "ServingMetrics", "SCHEMA_VERSION",
    "load_metrics", "validate_metrics", "ClassifierAdapter",
    "InferenceServer", "LMAdapter",
]
