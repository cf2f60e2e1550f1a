"""repro_torch.serving — continuous train -> checkpoint -> hot-swap serving
in the port (port of ``repro.serving``).

The sim engine publishes checkpoints (``sim.publish_params_hook`` ->
``checkpoint.publish``, manifest written last and atomically); a batched
:class:`InferenceServer` picks them up through a :class:`CheckpointWatcher`
by double-buffered weight hot-swap (``hot_swap.py``: staging off the serve
path on the watcher's own CUDA stream, a pointer flip between batches); a
:class:`LoadGenerator` drives it open-loop at a configured QPS while
federated rounds keep training in the same process. Every run renders one
``repro.serve/v1`` metrics document (``metrics.py``).

``python -m repro_torch.serving`` runs the whole loop end to end;
``python -m repro_torch.serving.serve_llm`` serves an LM.
"""
from __future__ import annotations

from repro_torch.serving.hot_swap import CheckpointWatcher, WeightBuffers
from repro_torch.serving.loadgen import LoadGenerator
from repro_torch.serving.metrics import (SCHEMA_VERSION, ServingMetrics,
                                         load_metrics, validate_metrics)
from repro_torch.serving.server import (ClassifierAdapter, InferenceServer,
                                        LMAdapter)

__all__ = [
    "CheckpointWatcher", "WeightBuffers", "LoadGenerator", "ServingMetrics",
    "SCHEMA_VERSION", "load_metrics", "validate_metrics",
    "ClassifierAdapter", "InferenceServer", "LMAdapter",
]
