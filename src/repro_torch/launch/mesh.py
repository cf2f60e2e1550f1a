"""The 1-D ``clients`` mesh of the client-parallel round (port of the
clients-mesh part of ``repro.launch.mesh``).

The reference partitions a cohort of simulated clients over the local
devices of ONE process (a single-controller 1-D ``jax.sharding.Mesh``) and
runs each shard's local SGD, encode and pair-mask PRNG there; the gathered
stream is decoded once. The port keeps that process model: a
:class:`ClientsMesh` is a tuple of ``torch.device``s, one per shard, driven by
one process (``core.fedavg.run_round(mesh=...)``). There is no
``torch.distributed`` group: the gather is a concatenation onto the decode
device.

Shards that share one device are built explicitly, e.g.
``ClientsMesh((torch.device("cpu"),) * 8)``. That is the port's counterpart
of the reference's ``--xla_force_host_platform_device_count=8`` fake CPU
devices, and the only way to run shards on one GPU or on the CPU: the shards
then run one after the other on that device. :func:`make_clients_mesh` and
:func:`clients_mesh_for` take distinct local devices only.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.streams import CLIENT_AXIS, tree_group_count


@dataclasses.dataclass(frozen=True)
class ClientsMesh:
    """A 1-D mesh: shard ``s`` runs on ``devices[s]``; clients are split
    over the shards in order, ``C / size`` each."""

    devices: tuple
    axis_name: str = CLIENT_AXIS

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a clients mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def local_device_count(device_type: str = "cuda") -> int:
    """Local devices of ``device_type``: the CUDA device count, or 1 for
    the CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "cpu":
        return 1
    raise ValueError(f"unknown device type {device_type!r}")


def make_clients_mesh(n_devices: int | None = None, *,
                      device_type: str = "cuda") -> ClientsMesh:
    """1-D ``clients`` mesh over the first ``n_devices`` local devices of
    ``device_type`` (default: all of them)."""
    count = local_device_count(device_type)
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n} outside [1, {count}]")
    if device_type == "cpu":
        return ClientsMesh((torch.device("cpu"),))
    return ClientsMesh(tuple(torch.device(device_type, i) for i in range(n)))


def clients_mesh_for(cohort_size: int,
                     device_type: str = "cuda") -> ClientsMesh | None:
    """The largest usable clients mesh for this cohort, or None.

    Shards are equal, so the mesh size must divide the cohort: the largest
    divisor of ``cohort_size`` that fits the local device count. None when
    that divisor is 1 (one device or an indivisible cohort); callers then
    run the serial round."""
    n_dev = local_device_count(device_type)
    best = max((d for d in range(1, min(n_dev, cohort_size) + 1)
                if cohort_size % d == 0), default=1)
    if best <= 1:
        return None
    return make_clients_mesh(best, device_type=device_type)


def default_tree_groups(cohort_size: int) -> int:
    """Auto group count of the aggregation tree: about the square root of
    the cohort, at least 2 (``core.streams.tree_group_count`` for
    ``tree_groups=0``)."""
    return tree_group_count(0, cohort_size)
