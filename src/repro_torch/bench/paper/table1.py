"""Paper Table 1: model parameter sizes and update volumes, exact (port of
``benchmarks/table1_model_sizes.py``).

Parameters are counted on the port's own models, built on the meta device
(shapes only, nothing drawn); every count must equal the published size.
Volumes are reported under both bit accountings (``core/costs``): the
paper's 64-bit elements and the float32 wire format the ledger also tracks.
"""
from __future__ import annotations

import time

from repro_torch.core import costs
from repro_torch.models.paper_models import (PAPER_MODELS, TABLE1_PARAMS,
                                             build_model)
from repro_torch.sim.ledger import mib

# Table 1 "update volume" column: m * 64bit (double-precision accounting)
TABLE1_VOLUMES = {"mnist_mlp": "1.2M", "mnist_cnn": "4.44M",
                  "cifar_mlp": "44.6M", "cifar_vgg16": "112M"}


def run(quick: bool = False, device="cuda"):
    """Rows for every paper model; ``quick`` and ``device`` change nothing
    (the models are built on the meta device)."""
    rows = []
    for name in PAPER_MODELS:
        t0 = time.perf_counter()
        n = build_model(name, device="meta").n_params()
        us = (time.perf_counter() - t0) * 1e6
        dense_mb = mib(costs.PAPER_BITS.dense_bits(n))
        tpu_mb = mib(costs.TPU_BITS.dense_bits(n))
        ok = n == TABLE1_PARAMS[name]
        rows.append((f"table1/{name}", us,
                     f"params={n};published={TABLE1_PARAMS[name]};match={ok};"
                     f"update_volume={dense_mb:.2f}MiB;"
                     f"update_volume_tpu={tpu_mb:.2f}MiB;"
                     f"published_volume={TABLE1_VOLUMES[name]}"))
        if not ok:
            raise AssertionError(f"Table 1 mismatch for {name}: {n} params, "
                                 f"published {TABLE1_PARAMS[name]}")
    return rows
