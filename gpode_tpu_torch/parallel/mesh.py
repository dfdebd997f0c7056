"""Rank meshes and block layouts for multi-device GPODE training.

Counterpart of `gpode_tpu/parallel/mesh.py` on `torch.distributed`. The
model's parallel axes are

  * `dp` — data parallelism over sequences (the N axis),
  * `mc` — Monte-Carlo parallelism over the shooting-state samples (S),

and, implicitly, the shooting-segment axis (T), which rides inside each
rank's flattened (S_l * N_l * T) integration batch: every rank integrates
only its own block, with no collective inside the ODE solve. Parameters are
replicated; the only cross-rank traffic of a train step is the all-reduce of
its gradients and ELBO terms and that of its solver statistics
(`parallel/train.py`).

A :class:`Mesh` is the process group's ranks laid out row-major over the
named axes (rank = dp_index * mc + mc_index for `dp=2,mc=2`), as JAX lays
its devices out with `reshape`. In place of the JAX module's shardings it
gives each rank its coordinates and the index range of its block along an
axis.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch.distributed as dist


def parse_mesh_spec(spec: str) -> dict:
    """Parse a CLI mesh spec like 'dp=2,mc=4' into ordered {axis: size}.

    One size may be -1, inferred from the world size (`make_mesh`). The
    shooting drivers and `scripts/bench.py` accept `--mesh dp=2,mc=4`."""
    axis_sizes = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(f"bad mesh spec {spec!r}: expected 'axis=size' "
                             f"entries separated by commas, got {part!r}")
        name, _, size = part.partition("=")
        axis_sizes[name.strip()] = int(size)
    return axis_sizes


def world_size_and_rank() -> tuple[int, int]:
    """(world size, rank) of the default process group when there is one,
    else of the `torchrun` environment (WORLD_SIZE, RANK), else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return (int(os.environ.get("WORLD_SIZE", 1)),
            int(os.environ.get("RANK", 0)))


class Mesh:
    """The ranks of a process group over named axes, and this rank's place
    in it. `shape` maps each axis to its size; `coords` this rank's index
    along each axis; `size` is the world size."""

    def __init__(self, axis_sizes: dict, rank: int):
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside the mesh {self.shape}")
        self.rank = rank
        self.coords = self.coords_of(rank)

    def coords_of(self, rank: int) -> dict:
        """{axis: index} of `rank` (row-major over the axes)."""
        coords, rest = {}, rank
        for name in reversed(self.axis_names):
            rest, coords[name] = divmod(rest, self.shape[name])
        return {name: coords[name] for name in self.axis_names}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def axis_size(self, axis: str) -> int:
        """The size of `axis`, 1 when the mesh has no such axis."""
        return self.shape.get(axis, 1)

    def block(self, axis: str, total: int) -> tuple[int, int]:
        """[lo, hi) of this rank's block of `total` items split evenly over
        `axis` (the whole range when the mesh has no such axis)."""
        parts = self.axis_size(axis)
        if total % parts:
            raise ValueError(f"{total} items do not split over {axis}={parts}")
        step = total // parts
        lo = self.coords.get(axis, 0) * step
        return lo, lo + step

    def sequence_block(self, n: int) -> tuple[int, int]:
        """This rank's sequences of N: its block over `dp`."""
        return self.block("dp", n)

    def sample_block(self, s: int) -> tuple[int, int]:
        """This rank's shooting-state samples of S: its block over `mc`."""
        return self.block("mc", s)


def make_mesh(axis_sizes: Optional[dict] = None,
              world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A mesh over the world; default: all ranks on one `dp` axis.

    axis_sizes: ordered {axis_name: size}; the sizes must multiply to the
    world size (one size may be -1 to infer it). `world_size` and `rank`
    default to the process group's, or to the `torchrun` environment's
    before the group is started (`world_size_and_rank`), so a mesh that
    cannot fit is refused before any rank joins a group."""
    ws, rk = world_size_and_rank()
    world_size = ws if world_size is None else world_size
    rank = rk if rank is None else rank
    if axis_sizes is None:
        axis_sizes = {"dp": world_size}
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world_size // known
    if math.prod(sizes) != world_size or min(sizes) < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {world_size} "
                         f"ranks")
    return Mesh(dict(zip(names, sizes)), rank)
