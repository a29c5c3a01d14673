"""The device mesh (``hpccg_tpu.parallel.mesh``), single-controller.

The JAX package's mesh is single-controller: one Python process drives
every shard under shard_map, and its tests run 8 virtual CPU devices in one
process. The port's mesh is the same kind of thing: one process holding a
list of torch devices, one shard per rank, ranks in z order (rank r owns
global z-planes [r*nz, (r+1)*nz), the reference's z-stacked partition,
generate_matrix.cpp:225-229). A device may appear more than once:

- ``devices=["cpu"] * n`` gives n ranks on the CPU, the counterpart of
  XLA's forced host device count (``--xla_force_host_platform_device_count``);
- ``devices=["cuda:0"] * n`` gives n ranks on one card, which is how the
  collective kernels are held at 1-8 ranks on one H100;
- with no ``devices``, the mesh takes the first n CUDA devices, one rank
  each.

A sharded vector is a tuple of flat per-rank tensors, each on its rank's
device; it looks the same whether the shards share a card or not. Only the
1-D z mesh is ported; the 2-D (host, z) mesh waits (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

Z_AXIS = "z"
Axis = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[r]`` holds rank r's shard."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (Z_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        """Every rank on the first rank's device."""
        return all(d == self.devices[0] for d in self.devices)

    def shard(self, v: torch.Tensor) -> tuple:
        """A global flat tensor -> its per-rank shards (equal blocks, rank
        order), each a contiguous copy on its rank's device."""
        if v.dim() != 1 or v.numel() % self.size:
            raise ValueError(f"cannot shard a tensor of shape {tuple(v.shape)} over {self.size} ranks")
        return tuple(part.to(dev).clone() for part, dev in zip(v.chunk(self.size), self.devices))

    def unshard(self, parts, device=None) -> torch.Tensor:
        """Per-rank shards -> the global flat tensor on ``device`` (default:
        rank 0's)."""
        device = self.devices[0] if device is None else device
        return torch.cat([p.reshape(-1).to(device) for p in parts])


def make_mesh(n_devices: Optional[int] = None, *, axis: str = Z_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (first ``n_devices`` of them), or over the
    first ``n_devices`` CUDA devices; raises when there are fewer, as the
    JAX package does."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices), (axis,))


def row_axis(mesh: Mesh) -> Axis:
    """The row-partition axis: the mesh's one axis name."""
    return mesh.axis_names[0]


def axis_size(mesh: Mesh, axis: Axis) -> int:
    """Ranks along ``axis``."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's {mesh.axis_names}")
    return mesh.size
