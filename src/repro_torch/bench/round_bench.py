"""Federated-round benchmarks (suite key ``round`` -> BENCH_torch_round.json;
port of ``repro.bench.round_bench``).

Times one full ``core.fedavg.run_round`` — local SGD for the whole cohort,
THGS encode, the round's pair-mask launch, the scatter decode, the server
update — on mnist_mlp at full width (784-200-10) in these configurations:

  * ``serial``  — the single-device round (``mesh=None``);
  * ``sharded`` — the client-parallel round (DESIGN.md §11) over a 1-D
    ``clients`` mesh of distinct local devices (``launch.mesh
    .clients_mesh_for``), present only when the process has more than one
    device that divides the cohort. On one card (or the CPU) the suite
    writes the reference's info row ``round/sharded_c{C}``
    ``unavailable_single_device``: shards that share one device run one
    after another, which is no speed-up to time;
  * a secure-aggregation **dropout** round of each (Bonawitz recovery on
    the hot path).

All entries are min-of-reps (``timing.measure``); every timed call ends
with ``timing.sync``.
"""
from __future__ import annotations

import torch

from repro_torch.bench.timing import entry, measure, sync
from repro_torch.core import fedavg
from repro_torch.core.types import FedConfig, SecureAggConfig, THGSConfig


def _setup(n_clients: int, local_steps: int, batch: int, device,
           seed: int = 0):
    from repro_torch.models.paper_models import (build_model,
                                                 cross_entropy_loss)

    model = build_model("mnist_mlp").init_(
        torch.Generator().manual_seed(seed))
    loss_fn = cross_entropy_loss(model)
    params = {n: p.detach().to(device) for n, p in model.params().items()}
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((n_clients, local_steps, batch, 784), generator=gen)
    y = torch.randint(0, 10, (n_clients, local_steps, batch), generator=gen)
    batches = {c: (x[c].to(device), y[c].to(device))
               for c in range(n_clients)}
    fed = FedConfig(n_clients=n_clients, clients_per_round=n_clients,
                    local_steps=local_steps, local_batch=batch,
                    local_lr=0.05, rounds=100)
    # time_varying=False pins the k schedule: every timed call runs the
    # same stream shapes
    thgs = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01, time_varying=False)
    sa = SecureAggConfig(mask_ratio=0.01, seed=11)
    return model, loss_fn, params, batches, fed, thgs, sa


def _round_timer(params, batches, loss_fn, fed, thgs, sa, device, *, mesh,
                 dropped=()):
    def call():
        state = fedavg.init_state(params, fed)
        state = fedavg.run_round(state, batches, loss_fn, fed, thgs, sa,
                                 dropped=dropped, mesh=mesh)
        sync(device)
        return state

    return call


def entries(quick: bool = False, device="cuda") -> list[dict]:
    from repro_torch.launch.mesh import clients_mesh_for

    device = torch.device(device)
    if quick:
        C, steps, batch, reps = 8, 2, 32, 2
    else:
        C, steps, batch, reps = 32, 5, 50, 3
    _, loss_fn, params, batches, fed, thgs, sa = _setup(C, steps, batch,
                                                        device)
    mesh = clients_mesh_for(C, device.type)
    n_dev = mesh.size if mesh is not None else 1
    model_size = sum(x.numel() for x in params.values())
    dropped = tuple(range(max(1, C // 4)))   # recoverable: threshold=0.6

    out = [entry(f"round/model_size_c{C}", 0.0,
                 f"{model_size}_params_mnist_mlp")]
    us_serial = measure(
        _round_timer(params, batches, loss_fn, fed, thgs, sa, device,
                     mesh=None), reps)
    out.append(entry(f"round/serial_c{C}", us_serial,
                     f"{C / (us_serial / 1e6):.0f}_clients_per_s", reps=reps))
    us_serial_drop = measure(
        _round_timer(params, batches, loss_fn, fed, thgs, sa, device,
                     mesh=None, dropped=dropped), reps)
    out.append(entry(f"round/serial_dropout_c{C}", us_serial_drop,
                     f"{len(dropped)}_dropped", reps=reps))
    if mesh is None:
        out.append(entry(f"round/sharded_c{C}", 0.0,
                         "unavailable_single_device"))
        return out
    us_sharded = measure(
        _round_timer(params, batches, loss_fn, fed, thgs, sa, device,
                     mesh=mesh), reps)
    out.append(entry(f"round/sharded_c{C}_d{n_dev}", us_sharded,
                     f"{C / (us_sharded / 1e6):.0f}_clients_per_s",
                     reps=reps))
    us_sharded_drop = measure(
        _round_timer(params, batches, loss_fn, fed, thgs, sa, device,
                     mesh=mesh, dropped=dropped), reps)
    out.append(entry(f"round/sharded_dropout_c{C}_d{n_dev}", us_sharded_drop,
                     f"{len(dropped)}_dropped", reps=reps))
    out.append(entry(f"round/speedup_c{C}_d{n_dev}", 0.0,
                     f"{us_serial / us_sharded:.2f}x_vs_serial"))
    return out

