"""Meshes — port of ``repro.launch.mesh``: the logical datacenter meshes of
the FL train step and the 1-D ``clients`` mesh of the client-parallel round.

**The datacenter meshes.** A :class:`LogicalMesh` is axis names, axis sizes
and the device each position runs on, driven by one process; like a JAX
``Mesh`` it takes ``devices``, an array of the mesh's shape (or one device
for every position). The production layouts are the reference's: one pod
``(data 16, model 16)``, or two ``(pod 2, data 16, model 16)`` where
``pod`` is the federation axis (each pod one cross-silo participant);
:func:`make_production_mesh` and :func:`make_debug_mesh` take ``devices=``,
one device a pod or one a position. The port's FL step runs each
participant along the federation axis on its own devices: its ``data``
positions form groups (:func:`participant_groups`: a device and a
contiguous run of positions), over which its parameters are sharded by the
``fsdp`` rule (``launch/fsdp.py``); a participant of one group computes as
one unsharded model on that device (:func:`participant_device`). Where the
``model`` positions of a ``data`` position span devices, a group is a row
of the participant's ``(data group, model position)`` grid, one device a
cell, and the participant runs tensor-parallel over it (``launch/tp.py``);
:func:`participant_grids` gives every participant that one layout. The
block layout depends only on the logical shape (``data x model`` blocks a
participant), so the multi-pod layout runs on one card with the
reference's numerics. :func:`logical_rules` maps the model's logical axis
names onto the mesh axes, as the reference's.

**The clients mesh.** The reference partitions a cohort of simulated clients over the local
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
import math

import numpy as np
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


# NVIDIA H100 SXM (data sheet): dense bf16 tensor-core peak and HBM3 rate,
# per card, for roofline bounds.
PEAK_FLOPS_BF16 = 989e12     # FLOP/s
HBM_BW = 3.35e12             # bytes/s
# NVLink 4 inside a node of 8 (H100 SXM data sheet: 900 GB/s a card, both
# directions): 450 GB/s a direction.
NVLINK_BW = 450e9            # bytes/s per card
# Between nodes (DGX H100 data sheet: eight 400 Gb/s ConnectX-7 ports for
# eight cards): 50 GB/s a direction per card. The production meshes' 256 /
# 512 positions span 32 / 64 nodes, and a collective over the data or pod
# axis crosses nodes, so the roofline's collective term takes this figure.
INTER_NODE_BW = 50e9         # bytes/s per card


def _device_array(devices, shape: tuple) -> np.ndarray:
    """``devices`` as an object array of ``torch.device`` of ``shape``: one
    device fills every position; an array of the mesh's shape, or of its
    size, gives one a position; an array of a leading part of the shape
    (one device a pod on the multi-pod layout) fills the rest."""
    if isinstance(devices, (str, torch.device)):
        arr = np.empty((), dtype=object)
        arr[()] = devices
    else:
        arr = np.asarray(devices, dtype=object)
    if arr.shape != shape[:arr.ndim]:
        if arr.size != math.prod(shape):
            raise ValueError(f"devices of shape {arr.shape} do not fit a "
                             f"mesh of shape {shape}")
        arr = arr.reshape(shape)
    arr = np.broadcast_to(arr.reshape(arr.shape + (1,) * (len(shape)
                                                          - arr.ndim)),
                          shape)
    out = np.empty(shape, dtype=object)
    out.reshape(-1)[:] = [torch.device(d) for d in arr.reshape(-1)]
    return out


class LogicalMesh:
    """A named mesh run by one process: ``devices`` is a numpy object
    array of ``torch.device`` of the mesh's shape (``devices.shape``,
    ``devices.size`` as a JAX mesh's), one per position; positions may
    share a device. ``device`` is one device for every position, or an
    array (nested sequence) of the mesh's shape or size, or of a leading
    part of its shape (one device a pod)."""

    def __init__(self, shape: tuple, axis_names: tuple, device="cuda"):
        shape = tuple(int(d) for d in shape)
        if len(shape) != len(axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"shape {shape} does not fit axes "
                             f"{axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = _device_array(device, shape)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` with no index is the current card, as a tensor placed there
    reports it."""
    if device.type == "cuda" and device.index is None \
            and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def participant_device(mesh: LogicalMesh, fed_axis: str,
                       p: int) -> torch.device:
    """The device that federation participant ``p`` (index ``p`` along
    ``fed_axis``) runs on: the one device of its positions. Raises
    ``NotImplementedError`` when they span several devices
    (:func:`participant_groups` gives a spread participant's groups)."""
    sub = np.take(mesh.devices, p, axis=mesh.axis_names.index(fed_axis))
    devs = sorted({_canonical(d) for d in sub.reshape(-1)}, key=str)
    if len(devs) > 1:
        raise NotImplementedError(
            f"participant {p} along {fed_axis!r} spans devices "
            f"{[str(d) for d in devs]}: it has no one device "
            "(participant_groups gives its groups)")
    return devs[0]


def participant_groups(mesh: LogicalMesh, fed_axis: str | None,
                       p: int = 0) -> list:
    """Participant ``p``'s ``data`` positions as groups, in position order:
    ``(device, positions)`` (``positions`` a ``range``), or, where the
    ``model`` positions of a ``data`` position span devices, ``(cells,
    positions)`` with ``cells`` one device a ``model`` position (the
    group's row of the participant's ``(data group, model position)``
    grid: tensor parallelism, ``launch/tp.py``). Adjacent ``data``
    positions whose devices (or cell rows) are equal merge into one group.
    ``fed_axis`` None takes the whole mesh as one participant. Each
    device's (or row's) positions must form one contiguous run along
    ``data`` (``ValueError`` otherwise). A participant without a ``data``
    axis (or whose federation axis is ``data``) is one position; one
    without a ``model`` axis has one ``model`` position."""
    axes = list(mesh.axis_names)
    sub = mesh.devices
    if fed_axis is not None:
        sub = np.take(sub, p, axis=axes.index(fed_axis))
        axes.remove(fed_axis)
    if "data" in axes:
        sub = np.moveaxis(sub, axes.index("data"), 0)
        axes.remove("data")
        axes.insert(0, "data")
    else:
        sub = sub.reshape((1,) + sub.shape)
        axes.insert(0, "data")
    if "model" in axes:
        sub = np.moveaxis(sub, axes.index("model"), -1)
    rows = sub.reshape(sub.shape[0], -1, sub.shape[-1] if "model" in axes
                       else 1)
    spread = any(len({_canonical(d) for d in row.reshape(-1)}) > 1
                 for row in rows)
    groups: list = []
    for i, row in enumerate(rows):
        if spread:
            cells = [{_canonical(d) for d in col} for col in row.T]
            if any(len(c) > 1 for c in cells):
                raise ValueError(
                    f"participant {p}'s data position {i} places one model "
                    "position on several devices")
            dev = tuple(c.pop() for c in cells)
        else:
            dev = _canonical(row.reshape(-1)[0])
        if groups and groups[-1][0] == dev:
            groups[-1] = (dev, range(groups[-1][1].start, i + 1))
            continue
        if any(d == dev for d, _ in groups):
            raise ValueError(
                f"participant {p}'s data positions on {dev} are not one "
                "contiguous run: a device's positions must be adjacent "
                "along 'data'")
        groups.append((dev, range(i, i + 1)))
    return groups


def participant_grids(mesh: LogicalMesh, fed_axis: str) -> list:
    """Every participant's :func:`participant_groups` along ``fed_axis``,
    in one layout: where any participant's model positions span devices,
    each group of the others is a grid row too (its one device a model
    position), so that every participant splits the model alike."""
    out = [participant_groups(mesh, fed_axis, p)
           for p in range(mesh.shape[fed_axis])]
    if any(isinstance(gs[0][0], tuple) for gs in out):
        m = mesh.shape.get("model", 1)
        out = [[(d if isinstance(d, tuple) else (d,) * m, pos)
                for d, pos in gs] for gs in out]
    return out


def group_cells(dev) -> tuple:
    """A group's devices, one a ``model`` position: ``dev`` itself when a
    group's entry is one device (its model positions merged)."""
    return tuple(dev) if isinstance(dev, (tuple, list)) else (dev,)


def lead_device(dev) -> torch.device:
    """A group's lead device: its ``model`` position 0's."""
    return group_cells(dev)[0]


def _mesh_devices(devices, device, n_pods: int):
    """``make_*_mesh``'s placement: ``devices`` (one a pod, or one a
    position) when given, else ``device`` everywhere."""
    if devices is None:
        return device
    arr = np.asarray(devices, dtype=object)
    if n_pods == 1 and arr.size == 1:     # a single-pod mesh is one pod
        return arr.reshape(-1)[0]
    return arr


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         devices=None) -> LogicalMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``; every position on ``device``, or placed by ``devices``
    (one device a pod, or one a position)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes,
                       _mesh_devices(devices, device, 2 if multi_pod else 1))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False, device="cuda",
                    devices=None) -> LogicalMesh:
    """A small mesh: (pod 2, data, model) with ``multi_pod``, else (data,
    model); placed as :func:`make_production_mesh`'s."""
    if multi_pod:
        return LogicalMesh((2, n_data, n_model), ("pod", "data", "model"),
                           _mesh_devices(devices, device, 2))
    return LogicalMesh((n_data, n_model), ("data", "model"),
                       _mesh_devices(devices, device, 1))


def logical_rules(mesh, *, fsdp: bool = True,
                  fed_axis: str | None = None) -> dict:
    """The model's logical axis names -> this mesh's axes. ``fed_axis`` (the
    federation axis of FL training) is left out of ``fsdp`` and the batch
    axes: each participant holds a whole model."""
    axes = mesh.axis_names
    has_pod = "pod" in axes
    batch_axes = tuple(a for a in axes
                       if a in ("pod", "data") and a != fed_axis)
    fsdp_axis = ("data" if (fsdp and "data" in axes and fed_axis != "data")
                 else None)
    return {
        "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "seq": "model",
        "model": "model",
        "heads": "model",
        "expert": "model",
        "vocab": "model",
        "fsdp": fsdp_axis,
        "kv_seq": "model",
        "pod": "pod" if has_pod else None,
    }
