"""The device list a sharded index is laid out over.

Counterpart of ``duckdb_lm_diskann_tpu/parallel/mesh.py``. In the JAX
package a mesh is a ``jax.sharding.Mesh`` with one named axis, and
``shard_leading`` / ``replicated`` name how an array is split over it. The
port's mesh is an ordered list of ``torch.device``, one per shard: shard s
keeps its tensors on ``mesh[s]``. Several shards may share a device
(``[cuda:0] * 4`` puts four shards on one card, ``[cpu] * 8`` is the CPU
tests' mesh) and one process may drive several cards
(``cuda:0 .. cuda:3``). Placement is simply the device a shard's tensors
were created on, so ``shard_leading`` and ``replicated`` have no
counterpart here: nothing is stacked into one global array, and a
replicated value is a host value or a copy on each device.

``make_mesh`` defaults to every visible card and raises when there is
none, unless the caller passes the CPU's devices explicitly; it never
falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def make_mesh(devices=None, n: int | None = None) -> list[torch.device]:
    """The shard devices: ``devices`` (any iterable of devices or device
    strings), else every visible CUDA card; ``n`` keeps the first n (or
    cycles ``devices`` when it is a single device: ``make_mesh("cpu", 8)``
    is eight CPU shards)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA card is visible; pass the devices "
                "explicitly (for example make_mesh(['cpu'] * 4))"
            )
        devices = [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())
        ]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * (n or 1)
    mesh = [torch.device(d) for d in devices]
    if n is not None:
        if n > len(mesh):
            raise ValueError(f"requested {n} devices, have {len(mesh)}")
        mesh = mesh[:n]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    for d in mesh:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh(): {d} requested, CUDA is not available")
    return mesh


def check_placement(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``tensor`` lies on ``device`` (a shard on the wrong
    device is an error, never moved silently)."""
    want = torch.device(device)
    got = tensor.device
    if got.type != want.type or (
        want.index is not None and got.index != want.index
    ):
        raise RuntimeError(f"{what} lies on {got}, its shard's device is {want}")


class ProcessMesh:
    """The shards of a multi-process index (``multihost.py``): every
    process holds ``devices``, one device per shard it owns, and the shards
    are numbered process-major: process r owns shards r * len(devices) ..
    (r + 1) * len(devices) - 1 of ``world_size * len(devices)``."""

    def __init__(self, devices, rank: int, world_size: int):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a process mesh needs at least one local device")
        self.rank = rank
        self.world_size = world_size

    @property
    def n_shards(self) -> int:
        return self.world_size * len(self.devices)

    @property
    def local_shards(self) -> list[int]:
        n = len(self.devices)
        return list(range(self.rank * n, (self.rank + 1) * n))

    def device_of(self, shard: int) -> torch.device:
        return self.devices[shard - self.rank * len(self.devices)]
