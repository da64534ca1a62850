"""The logical-axis Partitioner over a grid of ranks (counterpart of
``large_scale_recommendation_tpu.parallel.partitioner``).

The JAX package lays devices out as a ``('data', 'model')`` mesh and
annotates arrays with logical axis names that one rules table maps onto
it. The port keeps the table and the names, over processes instead of
devices: one process per device in a ``torch.distributed`` group, its
ranks reshaped ``(n // model_parallel, model_parallel)`` in the order
``make_data_model_mesh`` reshapes devices. Rank ``r`` sits at data index
``r // m`` and model index ``r % m``, and holds two sub-groups:

- the data ring (ranks of its model index): the DSGD item shards rotate on
  it, and the ALS and serving gathers ride it;
- the model group (ranks of its data index): the partial dots of a
  rank-sharded table are summed over it.

    logical axis   role     the local slice ``place`` keeps
    ------------   ------   -------------------------------------------
    users          data     rows of user block p (p = data index)
    items          data     rows of item block p (rotates on the ring)
    ratings        data     device-major strata [k, ...]: cell p
    queries        (none)   whole
    rank           model    columns [j·r/m, (j+1)·r/m) (j = model index)

``place`` returns this rank's slice of a host array or tensor as a new
tensor on the rank's device; ``gather`` is its inverse (a collective).
The collectives themselves are ``parallel.collectives``; on an axis of
size 1 they are the identity, so one process needs no process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from large_scale_recommendation_tpu_torch.parallel import collectives
from large_scale_recommendation_tpu_torch.parallel.collectives import Axis
from large_scale_recommendation_tpu_torch.utils.device import resolve_device

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "DEFAULT_RULES", "LocalShard", "Partitioner",
    "as_partitioner", "make_data_model_mesh", "select_devices",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The rules table: logical axis name -> physical role (None: whole).
DEFAULT_RULES: tuple[tuple[str, str | None], ...] = (
    ("users", DATA_AXIS),
    ("items", DATA_AXIS),
    ("ratings", DATA_AXIS),
    ("queries", None),
    ("rank", MODEL_AXIS),
)


def _world() -> tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def select_devices(num_devices: int | None = None, devices=None) -> list:
    """The ranks a grid is built over: ``devices`` if given, else every
    rank of the process group in order, cut to ``num_devices``."""
    ranks = list(range(_world()[0])) if devices is None else list(devices)
    if num_devices is not None:
        if len(ranks) < num_devices:
            raise ValueError(f"need {num_devices} devices, have {len(ranks)}")
        ranks = ranks[:num_devices]
    return [int(r) for r in ranks]


def make_data_model_mesh(num_devices: int | None = None, devices=None,
                         model_parallel: int = 1) -> np.ndarray:
    """The rank grid ``[n // model_parallel, model_parallel]``: row p is
    data index p, column j model index j."""
    ranks = select_devices(num_devices, devices)
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n} devices")
    return np.asarray(ranks, np.int64).reshape(n // model_parallel,
                                               model_parallel)


@dataclasses.dataclass(frozen=True)
class LocalShard:
    """This rank's piece of a sharded array: the data, its (row, column)
    offset in the whole array, and the whole array's shape (what a
    sharded checkpoint writes)."""

    data: torch.Tensor
    offset: tuple[int, int]
    shape: tuple[int, ...]


class Partitioner:
    """The rank grid, this rank's place in it and its two sub-groups, and
    the rules table. Building one is collective when the process group has
    more than one rank (every rank creates every sub-group, in one order).

    ``num_devices`` must equal the group's size (default: it); ``device``
    is where this rank's tables live (``None``: the card, the process's
    current CUDA device; on a card the group must be NCCL)."""

    def __init__(self, rules: tuple[tuple[str, str | None], ...] =
                 DEFAULT_RULES, num_devices: int | None = None,
                 model_parallel: int = 1, device=None):
        world, rank = _world()
        if num_devices is not None and num_devices != world:
            raise ValueError(
                f"need {num_devices} devices, the process group has {world} "
                "(one process per device: start them with torchrun or "
                "initialize_distributed)")
        self.rules = tuple((str(k), v) for k, v in rules)
        self._rules = dict(self.rules)
        self.grid = make_data_model_mesh(world, model_parallel=model_parallel)
        self.rank = rank
        k, m = self.grid.shape
        di, mi = (int(a) for a in np.argwhere(self.grid == rank)[0])
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if (world > 1 and self.device.type == "cuda"
                and dist.get_backend() != "nccl"):
            raise RuntimeError(f"tables on {self.device} need an NCCL "
                               f"process group, this one is "
                               f"{dist.get_backend()}")
        data_groups = self._groups([list(self.grid[:, j]) for j in range(m)])
        model_groups = self._groups([list(self.grid[i, :]) for i in range(k)])
        self.data = Axis(DATA_AXIS, tuple(int(r) for r in self.grid[:, mi]),
                         di, data_groups[mi])
        self.model = Axis(MODEL_AXIS, tuple(int(r) for r in self.grid[di]),
                          mi, model_groups[di])
        self.world = Axis("world", tuple(range(world)), rank, None)

    @staticmethod
    def _groups(members: list[list[int]]) -> list:
        """One process group per member list (created by every rank, in
        order); ``None`` where the list is the whole world or one rank."""
        world = _world()[0]
        if world == 1 or len(members[0]) in (1, world):
            return [None] * len(members)
        return [dist.new_group([int(r) for r in ranks]) for ranks in members]

    def __repr__(self) -> str:
        return (f"Partitioner(grid={tuple(self.grid.shape)}, "
                f"rank={self.rank}, device={self.device})")

    @classmethod
    def create(cls, distributed_config=None,
               rules: tuple[tuple[str, str | None], ...] = DEFAULT_RULES,
               model_parallel: int = 1, device=None) -> "Partitioner":
        """Bring up the process group (``initialize_distributed``: a no-op
        for one process) and build the partitioner over all its ranks."""
        from large_scale_recommendation_tpu_torch.parallel.distributed import (
            initialize_distributed,
        )

        initialize_distributed(distributed_config, device=device)
        return cls(rules=rules, model_parallel=model_parallel, device=device)

    # -- the rules table ----------------------------------------------------

    @property
    def data_axis(self) -> str:
        return DATA_AXIS

    @property
    def model_axis(self) -> str:
        return MODEL_AXIS

    @property
    def num_blocks(self) -> int:
        """k: the data ring's size."""
        return int(self.grid.shape[0])

    @property
    def model_parallel(self) -> int:
        return int(self.grid.shape[1])

    @property
    def world_size(self) -> int:
        return int(self.grid.size)

    def physical_axis(self, logical: str) -> str | None:
        """One logical axis → its physical axis (None: whole). Unknown
        names raise: the rules table is a closed vocabulary."""
        try:
            role = self._rules[logical]
        except KeyError:
            raise KeyError(
                f"unknown logical axis {logical!r}; rules table knows "
                f"{sorted(self._rules)}") from None
        if role not in (None, DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"rule {logical!r} -> {role!r} names no axis of "
                             f"the grid {(DATA_AXIS, MODEL_AXIS)}")
        return role

    def spec(self, *logical: str | None) -> tuple:
        """Logical axis names → physical axis names, per dimension (the
        ``PartitionSpec`` of the JAX package, as a tuple)."""
        return tuple(None if ax is None else self.physical_axis(ax)
                     for ax in logical)

    # -- placement ----------------------------------------------------------

    def local_range(self, shape, *logical: str | None) -> list[tuple[int,
                                                                     int]]:
        """This rank's ``[start, stop)`` in each dimension of an array of
        ``shape`` laid out as ``logical`` (trailing dimensions whole)."""
        out = []
        for d, size in enumerate(shape):
            role = (self.physical_axis(logical[d])
                    if d < len(logical) and logical[d] is not None else None)
            axis = {DATA_AXIS: self.data, MODEL_AXIS: self.model}.get(role)
            parts, idx = (1, 0) if axis is None else (axis.size, axis.index)
            if size % parts:
                raise ValueError(
                    f"dimension {d} ({size}) does not split over the "
                    f"{role} axis ({parts})")
            step = size // parts
            out.append((idx * step, (idx + 1) * step))
        return out

    def place(self, x, *logical: str | None) -> torch.Tensor:
        """This rank's slice of ``x`` (a host array or a tensor, the whole
        array on every rank) as a new contiguous tensor on the rank's
        device."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        sl = tuple(slice(a, b) for a, b in self.local_range(t.shape,
                                                             *logical))
        return t[sl].to(self.device).clone(
            memory_format=torch.contiguous_format)

    def rank_slice(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's columns of full factor rows ``X`` [..., rows, rank]
        laid out as ``(..., 'rank')`` (all of them at ``model_parallel``
        1): a view."""
        c0, c1 = self.local_range(X.shape[-1:], "rank")[0]
        return X[..., c0:c1]

    def gather(self, local: torch.Tensor, *logical: str | None
               ) -> torch.Tensor:
        """The whole array on every rank from each rank's ``place`` slice
        (a collective: the model axis's columns, then the data axis's
        rows)."""
        t = local
        roles = [None if ax is None else self.physical_axis(ax)
                 for ax in logical]
        for role, axis in ((MODEL_AXIS, self.model), (DATA_AXIS, self.data)):
            for d, r in enumerate(roles):
                if r == role:
                    t = collectives.gather(axis, t, dim=d)
        return t

    def local_shard(self, local: torch.Tensor,
                    *logical: str | None) -> LocalShard:
        """``local`` (this rank's ``place`` slice) with its offset and the
        whole array's shape."""
        shape = []
        for d, size in enumerate(local.shape):
            role = (self.physical_axis(logical[d])
                    if d < len(logical) and logical[d] is not None else None)
            parts = {DATA_AXIS: self.data.size,
                     MODEL_AXIS: self.model.size}.get(role, 1)
            shape.append(int(size) * parts)
        rng = self.local_range(shape, *logical)
        offset = (rng[0][0] if rng else 0, rng[1][0] if len(rng) > 1 else 0)
        return LocalShard(local, offset, tuple(shape))

    # -- the ring -------------------------------------------------------------

    def ring_backward(self) -> tuple[tuple[int, int], ...]:
        """The data ring's rotation as (from, to) positions: shard j moves
        to j − 1 (≙ ``nextRatingBlock``, DSGDforMF.scala:611-619)."""
        k = self.num_blocks
        return tuple((j, (j - 1) % k) for j in range(k))

    def ring_shift(self, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """``collectives.ring_shift`` on the data ring."""
        return collectives.ring_shift(self.data, *tensors)

    # -- guards ---------------------------------------------------------------

    def require_no_model_parallel(self, what: str) -> None:
        """Refuse a path that accumulates over the full rank with no
        reduction over the model axis (the CUDA step pair holds full
        rows)."""
        if self.model_parallel != 1:
            raise NotImplementedError(
                f"{what} does not support rank (model-axis) sharding; "
                f"mesh has model_parallel={self.model_parallel}")

    def require_rank_divisible(self, rank: int, what: str) -> None:
        """Rank-sharded tables split their columns evenly over the model
        axis; refuse a rank that does not split."""
        m = self.model_parallel
        if rank % m:
            raise ValueError(
                f"{what}: rank {rank} is not divisible by "
                f"model_parallel={m}; pick a rank that splits evenly "
                f"over the 'model' axis")


def as_partitioner(mesh_or_partitioner,
                   rules: tuple[tuple[str, str | None], ...] = DEFAULT_RULES,
                   ) -> Partitioner:
    """A ``Partitioner`` passes through; ``None`` builds one over the whole
    process group, on the card."""
    if isinstance(mesh_or_partitioner, Partitioner):
        return mesh_or_partitioner
    if mesh_or_partitioner is None:
        return Partitioner(rules=rules)
    raise TypeError(f"expected a Partitioner or None, got "
                    f"{type(mesh_or_partitioner).__name__}")
