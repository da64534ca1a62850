"""Multi-process bring-up and per-process rating shards (counterpart of
``large_scale_recommendation_tpu.parallel.distributed``).

The JAX package runs one controller per host over a global device mesh.
The port runs one process per device in a ``torch.distributed`` process
group: NCCL when the device is a card, gloo when the caller asks for the
CPU (as the tests do). A caller on the card that finds no NCCL gets an
error, never gloo.

- ``DistributedConfig.from_env`` reads the JAX package's ``LSR_*``
  variables, else the ones ``torchrun`` sets (``MASTER_ADDR`` /
  ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``);
- ``initialize_distributed`` brings the group up (a no-op for one process
  with no coordinator named, as in the JAX package) with an explicit
  timeout, so a mismatched collective fails instead of hanging;
- ``host_rating_shard`` is this process's rating partition, numpy.

- ``global_device_blocked`` is the on-device blocking over the whole
  group when each process holds only ITS ratings: the counts are summed
  over the group, the id → row assignment is drawn alike on every rank,
  and each entry travels (``collectives.exchange``) to the ranks of its
  user block, which lay out their own cells. No rank holds another's
  ratings or the whole layout; the result equals
  ``data.device_blocking.device_block_problem`` of the processes'
  ratings concatenated in rank order, sliced per rank;
- ``make_global_array`` is ``Partitioner.place`` under a physical spec.

``MeshDSGD.fit`` / ``fit_device`` instead take the whole ratings on every
rank (deterministic blocking), as the JAX package's single-process path.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from large_scale_recommendation_tpu_torch.core.initializers import (
    keyed_uniform_rows,
)
from large_scale_recommendation_tpu_torch.data import device_blocking as db
from large_scale_recommendation_tpu_torch.parallel import collectives
from large_scale_recommendation_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Process-group description: the coordinator (``host:port`` or a
    ``tcp://`` URL), the number of processes and this one's id."""

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    @staticmethod
    def from_env() -> "DistributedConfig":
        env = os.environ

        def num(*names):
            for n in names:
                if n in env:
                    return int(env[n])
            return None

        addr = env.get("LSR_COORDINATOR") or None
        if addr is None and env.get("MASTER_ADDR"):
            addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        return DistributedConfig(
            coordinator_address=addr,
            num_processes=num("LSR_NUM_PROCESSES", "WORLD_SIZE"),
            process_id=num("LSR_PROCESS_ID", "RANK"))


def initialize_distributed(config: DistributedConfig | None = None,
                           device=None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT
                           ) -> bool:
    """Bring up the process group for ``device`` (``None``: the card →
    NCCL; ``"cpu"`` → gloo). Returns True iff a group is up afterwards;
    one process with no coordinator named starts none (the same training
    script runs unchanged on one device). A group already up is kept. On a
    card the process's device becomes ``LOCAL_RANK`` (default: its rank
    modulo the cards on the host)."""
    cfg = config or DistributedConfig.from_env()
    if dist.is_initialized():
        return True
    if cfg.num_processes in (None, 1) and cfg.coordinator_address is None:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a process group on the card needs NCCL, and "
                               "this torch has none (gloo is not a "
                               "substitute for it)")
        backend = "nccl"
    else:
        if not dist.is_gloo_available():
            raise RuntimeError("a CPU process group needs gloo")
        backend = "gloo"
    if cfg.coordinator_address is None:
        raise ValueError("a multi-process group needs a coordinator_address")
    world = cfg.num_processes or 1
    rank = cfg.process_id or 0
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    addr = cfg.coordinator_address
    init_method = addr if "://" in addr else f"tcp://{addr}"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    return True


def host_rating_shard(
    ru: np.ndarray,
    ri: np.ndarray,
    rv: np.ndarray,
    process_id: int,
    num_processes: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """This process's rating partition: ``|user| % num_processes``. Every
    process applies the same filter to its copy, so the union over
    processes is exactly the dataset."""
    m = (np.abs(ru) % num_processes) == process_id
    return ru[m], ri[m], rv[m]


def make_global_array(host_data, mesh, spec) -> torch.Tensor:
    """This rank's slice of ``host_data`` (the whole array, indexed by
    global row) under a physical spec: per dimension ``"data"``,
    ``"model"`` or None (``Partitioner.spec``'s output)."""
    logical = {"data": "users", "model": "rank", None: None}
    return mesh.place(host_data, *(logical[ax] for ax in spec))


@dataclasses.dataclass
class GlobalBlockedArrays:
    """This rank's part of a blocked problem from ``global_device_blocked``:
    its tables and cells on its device (``MeshDSGD``'s local layout,
    ``build_mesh_dsgd_step``'s operands) and the id → row maps, whole, on
    the host."""

    U: torch.Tensor  # [rpb_u, rank / m] this rank's user block
    V: torch.Tensor  # [rpb_v, rank / m]
    ru: torch.Tensor  # int32 [k, bmax] device-major cells, block-local rows
    ri: torch.Tensor
    rv: torch.Tensor  # f32 [k, bmax]
    rw: torch.Tensor
    icu: torch.Tensor  # collision scales [k, bmax]
    icv: torch.Tensor
    omega_u: torch.Tensor  # f32 [rpb_u] this block's ω
    omega_v: torch.Tensor  # f32 [rpb_v]
    row_of_user: np.ndarray  # int64 [num_users], whole
    row_of_item: np.ndarray
    omega_u_host: np.ndarray  # f32 [k · rpb_u], whole
    omega_v_host: np.ndarray
    num_blocks: int
    rows_per_block_u: int
    rows_per_block_v: int
    minibatch: int

    @property
    def strata(self) -> tuple:
        """The cells in ``build_mesh_dsgd_step``'s order."""
        return (self.ru, self.ri, self.rv, self.rw, self.icu, self.icv)

    def holdout_rows(self, hu: np.ndarray, hi: np.ndarray):
        """Rows + seen-in-training mask for evaluation (host-side maps)."""
        ur = self.row_of_user[hu]
        ir = self.row_of_item[hi]
        mask = ((self.omega_u_host[ur] > 0)
                & (self.omega_v_host[ir] > 0)).astype(np.float32)
        return ur, ir, mask


def global_device_blocked(
    u_local,
    i_local,
    r_local,
    w_local,
    num_users: int,
    num_items: int,
    mesh,
    minibatch_multiple: int = 1,
    seed: int = 0,
    row_multiple: int = 8,
    rank: int = 8,
    init_scale: float = 0.1,
) -> GlobalBlockedArrays:
    """DSGD blocking over the whole process group, each process passing
    only ITS ratings (dense ids; equal lengths on every rank, padded with
    ``w_local = 0`` entries). A collective: every rank calls it.

    Equal, rank by rank, to ``device_block_problem`` of the ratings of
    every rank concatenated in rank order (same ``seed``; its entry draw is
    over the concatenation) cut to the rank's cells, with the per-id keyed
    init of ``init_factors_device``. On each rank: the weighted counts
    summed over the group; the user, item and entry permutations drawn
    alike; each entry sent to the ranks of its user block (a row exchange
    over the data ring, then one within the model group); the received
    entries ordered by (cell, the entry draw) and laid out into the rank's
    k cells, with the collision scales. The whole-group draw of the entry
    permutation is the one array of the group's size a rank holds."""
    part = mesh
    dev = part.device
    k = part.num_blocks
    me = part.data.index

    def put(a, dtype):
        a = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
        return a.to(device=dev, dtype=dtype)

    u, i = put(u_local, torch.int64), put(i_local, torch.int64)
    r, w = put(r_local, torch.float32), put(w_local, torch.float32)
    n_local = int(u.shape[0])
    lengths = collectives.gather(
        part.world, torch.tensor([n_local], device=dev)).cpu().tolist()
    if len(set(lengths)) != 1:
        raise ValueError(f"global_device_blocked needs equal-length local "
                         f"arrays on every rank (pad with w_local=0), got "
                         f"{lengths}")
    db.validate_dense_ids(u, i, num_users, num_items, "global_device_blocked")
    n = n_local * part.world_size
    counts_u, counts_v = (collectives.group_sum(part.world, c) for c in
                          db._weighted_counts(u, i, w, num_users, num_items))
    perm_u, perm_i, perm_e = db.draw_permutations(seed, num_users, num_items,
                                                  n, dev)
    rpb_u = db.rows_per_block(num_users, k, row_multiple)
    rpb_v = db.rows_per_block(num_items, k, row_multiple)
    row_of_u, omega_u, id_of_ur = db._assign_rows(perm_u, counts_u, k, rpb_u,
                                                  k * rpb_u)
    row_of_i, omega_v, id_of_ir = db._assign_rows(perm_i, counts_v, k, rpb_v,
                                                  k * rpb_v)
    # each entry's cell (stratum · k + user block), as _bucket_entries
    # assigns it, and its place in the entry draw
    g = part.rank * n_local + torch.arange(n_local, device=dev)
    urow, irow = row_of_u.long()[u], row_of_i.long()[i]
    flat = ((irow // rpb_v - urow // rpb_u) % k) * k + urow // rpb_u
    flat = torch.where(w > 0, flat, g % (k * k))
    sizes = collectives.group_sum(part.world,
                                  torch.bincount(flat, minlength=k * k))
    pos_of = torch.empty(n, dtype=torch.int64, device=dev)
    pos_of[perm_e] = torch.arange(n, device=dev)
    cols = (flat, urow, irow, r, w, pos_of[g])
    # to the ranks of the user block: over the data ring, then the model
    # group's members send each other what each received (row by row to
    # every member: their counts differ)
    cols = collectives.exchange(part.data, cols, cols[0] % k)
    m = part.model.size
    if m > 1:
        dest = torch.arange(m, device=dev).repeat(cols[0].shape[0])
        cols = collectives.exchange(
            part.model, [c.repeat_interleave(m, dim=0) for c in cols], dest)
    flat, urow, irow, r, w, pos = cols
    order = torch.argsort(flat * n + pos)
    flat, urow, irow, r, w = (c[order] for c in (flat, urow, irow, r, w))

    sizes_host = sizes.cpu()
    mbm = max(minibatch_multiple, 1)
    bmax = -(-max(int(sizes_host.max()), 1) // mbm) * mbm
    mine = sizes[me::k]  # this block's cells, stratum by stratum
    starts = torch.cumsum(mine, 0) - mine
    s = flat // k
    dest = s * bmax + (torch.arange(flat.shape[0], device=dev) - starts[s])

    def layout(vals, dtype):
        out = torch.zeros(k * bmax, dtype=dtype, device=dev)
        out[dest] = vals.to(dtype)
        return out.view(-1, mbm)

    su, si = layout(urow, torch.int32), layout(irow, torch.int32)
    sv, sw = layout(r, torch.float32), layout(w, torch.float32)
    icu, icv = db._inv_counts_2d(su, sw), db._inv_counts_2d(si, sw)
    shape = (k, bmax)
    (u0, u1), (v0, v1) = ((me * rpb, (me + 1) * rpb)
                          for rpb in (rpb_u, rpb_v))
    scale = float(np.float32(init_scale))
    return GlobalBlockedArrays(
        U=part.rank_slice(keyed_uniform_rows(id_of_ur[u0:u1], rank, scale)
                          ).contiguous(),
        V=part.rank_slice(keyed_uniform_rows(id_of_ir[v0:v1], rank, scale)
                          ).contiguous(),
        ru=(su % rpb_u).reshape(shape), ri=(si % rpb_v).reshape(shape),
        rv=sv.reshape(shape), rw=sw.reshape(shape), icu=icu.reshape(shape),
        icv=icv.reshape(shape), omega_u=omega_u[u0:u1].clone(),
        omega_v=omega_v[v0:v1].clone(),
        row_of_user=row_of_u.cpu().numpy().astype(np.int64),
        row_of_item=row_of_i.cpu().numpy().astype(np.int64),
        omega_u_host=omega_u.cpu().numpy(), omega_v_host=omega_v.cpu().numpy(),
        num_blocks=k, rows_per_block_u=rpb_u, rows_per_block_v=rpb_v,
        minibatch=mbm)
