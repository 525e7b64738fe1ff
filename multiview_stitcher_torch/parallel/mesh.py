"""Device mesh and sharding helpers.

The port of ``multiview_stitcher_tpu.parallel.mesh``. The reference splits
the pairwise-registration batch and the fusion chunk batch (or the output's
bands) along a leading axis over a 1-D ``jax.sharding.Mesh`` with
``shard_map``; here a :class:`Mesh` is a tuple of ``torch.device``s, and the
sharded paths run one call per mesh entry on its device, each on a
contiguous part of the leading axis (:func:`shard_bounds`), with the inputs
they all read replicated once per distinct device (:func:`replicate`).
Launches are asynchronous, so on several cards the parts overlap; the
results are gathered after every part has been issued.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from multiview_stitcher_torch.utils import misc as misc_utils

DATA_AXIS = "data"


def indexed_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current CUDA device,
    so that one card has one name."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A 1-D device mesh: one entry a shard, in order.

    ``devices`` is a sequence (or numpy array) of devices or device names,
    ``axis_names`` the mesh's one axis name. A device may appear more than
    once: ``Mesh([torch.device("cuda", 0)] * 4)`` is a virtual mesh of four
    shards on one card, and ``Mesh([torch.device("cpu")] * 8)`` one on the
    CPU, for tests and smoke runs on one device. ``devices``,
    ``axis_names``, ``shape[axis]`` and ``size`` are what the reference's
    callers read of a ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names=(DATA_AXIS,)):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"a Mesh has one axis, got {axis_names}")
        devices = tuple(
            indexed_device(d) for d in np.asarray(devices, dtype=object).reshape(-1)
        )
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device of the mesh once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh(devices={[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` if it is None or a :class:`Mesh`; raises TypeError else."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a multiview_stitcher_torch.parallel.mesh.Mesh, got {type(mesh).__name__}"
        )
    return mesh


def is_sharded(mesh) -> bool:
    """True for a :class:`Mesh` of more than one entry (the reference's
    ``mesh is not None and mesh.size > 1``)."""
    return check_mesh(mesh) is not None and mesh.size > 1


def get_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices, or all of them.
    Raises where there is no CUDA device; a CPU mesh is built explicitly,
    as ``Mesh([torch.device("cpu")] * n)``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "get_mesh() takes the CUDA devices and this machine has none; "
            "build a CPU mesh explicitly: Mesh([torch.device('cpu')] * n)"
        )
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


class Sharding(NamedTuple):
    """How a tensor is laid over a mesh: its leading axis split in one
    contiguous part per entry (``axis_name`` set), or replicated."""

    mesh: Mesh
    axis_name: Optional[str]


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> Sharding:
    """Sharding that splits the leading batch axis across the mesh."""
    if axis_name not in check_mesh(mesh).axis_names:
        raise ValueError(f"{axis_name!r} is not an axis of {mesh}")
    return Sharding(mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(check_mesh(mesh), None)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill_value=0.0):
    """Pad a batch axis so it divides evenly across devices."""
    n = arr.shape[axis]
    rem = n % multiple
    if rem == 0:
        return arr, n
    pad = multiple - rem
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill_value), n


def shard_bounds(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """The part ``[lo, hi)`` of a leading axis of length ``n`` that each
    mesh entry holds: ``ceil(n / mesh.size)`` rows each, in order, the last
    parts shorter or empty; for ``n`` a multiple of the mesh size, the
    reference's even split."""
    per = -(-int(n) // mesh.size)
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(mesh.size)]


def shard_parts(n: int, mesh: Mesh) -> List[Tuple[slice, torch.device]]:
    """(rows, device) of each mesh entry whose part of ``n`` rows
    (:func:`shard_bounds`) is not empty."""
    return [
        (slice(lo, hi), d)
        for (lo, hi), d in zip(shard_bounds(n, mesh), mesh.devices)
        if hi > lo
    ]


def resolve(mesh, device) -> Tuple[Optional[Mesh], torch.device]:
    """An entry point's ``mesh`` (checked) and device: ``device``, or the
    mesh's first device where the caller names none, or the CUDA device
    (``utils.misc.resolve_device``)."""
    mesh = check_mesh(mesh)
    if device is None and mesh is not None:
        device = mesh.devices[0]
    return mesh, misc_utils.resolve_device(device)


def replicate(tensor: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``tensor`` on the device of each mesh entry: one copy per distinct
    device (entries on one device share it)."""
    copies = {d: tensor.to(d) for d in check_mesh(mesh).distinct_devices}
    return [copies[d] for d in mesh.devices]


def shard_batch(arr, mesh: Mesh, axis_name: str = DATA_AXIS) -> List[torch.Tensor]:
    """``arr`` (numpy or a tensor) split along its leading axis into one
    contiguous part per mesh entry (:func:`shard_bounds`), each on its
    entry's device."""
    batch_sharding(mesh, axis_name)
    t = torch.as_tensor(arr)
    return [t[lo:hi].to(d) for (lo, hi), d in zip(shard_bounds(len(t), mesh), mesh.devices)]


def gather(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The parts of a sharded batch joined along their leading axis on
    ``device``."""
    return torch.cat([p.to(device) for p in parts])
