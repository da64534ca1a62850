"""The DSGD stratum sweep on Hopper (counterpart of
``large_scale_recommendation_tpu.ops.pallas_sgd``).

Hand-written CUDA kernels (``csrc/dsgd_sweep.cu``) replace the JAX
package's Pallas kernels ``_sweep_kernel`` and ``_stratum_kernel``. One
stratum is ``n_mb`` minibatch steps; each step is two launches that cover
all k row-disjoint visits of the stratum at once, driven by a step plan
(``build_step_plan``, built once per fit) that groups each step's real
entries by item row and by user row, so that every row of a step has one
owning warp (or, for a long row, one thread block):

- ``sgd_item_rows`` — ``sgd_item_rows_kernel`` (kernel A): per item row,
  gathers the entries' user rows, writes each entry's error ``e`` and the
  row's old value (the snapshot, by item row), adds the item deltas into
  the row in entry order and writes it in place;
- ``sgd_user_rows`` — ``sgd_user_rows_kernel`` (kernel B): per user row,
  adds the user deltas from ``e`` and the snapshot into the row in entry
  order and writes it in place.

Every row is written by one owner in a fixed order: no atomics, no
per-entry delta scratch, and two runs give bit-equal tables.

bf16 tables (the TPU kernels' ``half=True`` branch: one f32 work copy and
one rounding per block visit, and every block is visited once per stratum)
rest in bf16 beside one f32 work table a side, and the same two kernels
take both (``store=(U16, V16)``): the plan marks each position's row at its
first and last step in the stratum (``StepPlan.v_flag`` / ``u_flag``), a
row is read from the bf16 table at its first step (upcast exactly) and
written to it at its last (rounded to nearest even), and the work table
carries it in between. The result is bit-equal to the earlier route,
``stratum_sweep_cast``: ``bf16_to_f32`` (``bf16_to_f32_kernel``) upcasting
both whole tables at each stratum's start and ``f32_to_bf16``
(``f32_to_bf16_kernel``) rounding them back at its end. That route stays as
the baseline the flagged one is held against; no path of the port takes
it.

Each wrapper launches its kernel for CUDA tensors (and counts the launch in
``LAUNCHES``) and uses its plain PyTorch version only for CPU tensors.
There is no fallback: a CUDA tensor either goes through the kernel or the
wrapper raises (the step kernels take f32 tables, and bf16 ones only as
``store`` beside them).

The same pair runs one rank's visits on the mesh (``block_sweep``, the
counterpart of ``pallas_block_sweep``, which the JAX mesh launches per
device per sub-step): a plan of the rank's device-major strata ``[k, 1,
b]`` (one visit per stratum, block-local rows), built once per fit, and
one visit's ``n_mb`` steps per call; a bf16 visit's work tables come from
the caching allocator.

Beside them, the plain versions of the TPU kernels' own contracts, for the
tests and the on-card comparisons: ``block_sweep_reference`` (one visit,
block-local rows — ``pallas_block_sweep``), ``stratum_sweep_reference``
(one stratum from ``build_stratum_operands``' visit-major operands —
``pallas_stratum_sweep``) and ``dsgd_train_reference`` (the whole training
loop of ``dsgd_train_cuda``, bf16 rounding points included). Every plain
version applies the one λ/ω rule of ``RegularizedSGDUpdater`` at a
constant η. The TPU's VMEM/SMEM budget helpers have no counterpart: the
wrappers' shape checks take their place.

``probe_variants`` (the counterpart of the JAX ``probe_variants``) times the
framework's own sweep (``"torch"``: ``ops.sgd.sgd_block_sweep``) against the
step pair (``"cuda"``: ``block_sweep`` over a one-visit plan) on one
realistic (stratum, block) visit drawn on the device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.core.updaters import (
    RegularizedSGDUpdater,
    _errors,
    constant_lr,
)
from large_scale_recommendation_tpu_torch.data.device_blocking import (
    _inv_counts_2d,
    truncated_exp_ids,
)
from large_scale_recommendation_tpu_torch.obs.introspect import (
    get_introspector,
)
from large_scale_recommendation_tpu_torch.obs.registry import get_registry
from large_scale_recommendation_tpu_torch.obs.trace import get_tracer
from large_scale_recommendation_tpu_torch.ops import sgd as sgd_ops
from large_scale_recommendation_tpu_torch.ops import _build
from large_scale_recommendation_tpu_torch.utils.device import resolve_device

# launches per kernel since the last reset (counted where the kernel is
# launched, and nowhere else)
LAUNCHES = {"sgd_item_rows_kernel": 0, "sgd_user_rows_kernel": 0,
            "bf16_to_f32_kernel": 0, "f32_to_bf16_kernel": 0}
FACTOR_DTYPES = (torch.float32, torch.bfloat16)
# touch flags of a plan position (``StepPlan.v_flag`` / ``u_flag``): its
# segment's row at its first / last step in the stratum; in item order also
# the gathered user row at its first (``csrc/dsgd_sweep.cu``: kFirst, kLast,
# kGatherFirst)
FIRST, LAST, GATHER_FIRST = 1, 2, 4
# a segment longer than this gets a thread block of its own, its entries
# dealt to the block's warps in chunks of this many (at most 32: a shorter
# segment must end inside the two 32-position windows its owner loads)
SEGMENT_CHUNK = 32

_LIB = "dsgd_sweep"
_bound: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the ctypes signatures of a ``dsgd_sweep`` library's entry
    points; returns it."""
    P, I64, I, F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_float)
    lib.dsgd_sweep_max_rank.restype = I
    lib.dsgd_sweep_max_rank.argtypes = []
    step = [I, I, P, I, I, P, P, I, F, F, P]  # e0 … stream
    lib.sgd_item_rows_launch.restype = I
    lib.sgd_item_rows_launch.argtypes = [P] * 8 + step
    lib.sgd_user_rows_launch.restype = I
    lib.sgd_user_rows_launch.argtypes = [P] * 7 + step
    if hasattr(lib, "sgd_item_rows_bf16_launch"):  # not in earlier sources
        lib.sgd_item_rows_bf16_launch.restype = I
        lib.sgd_item_rows_bf16_launch.argtypes = [P] * 11 + step
        lib.sgd_user_rows_bf16_launch.restype = I
        lib.sgd_user_rows_bf16_launch.argtypes = [P] * 9 + step
    for fn in (lib.bf16_to_f32_launch, lib.f32_to_bf16_launch):
        fn.restype = I
        fn.argtypes = [P, P, I64, P, P, I64, P]
    return lib


def _lib() -> ctypes.CDLL:
    """The built kernel library with its ctypes signatures declared (the
    first call from any thread builds it, under the library's build
    lock)."""
    global _bound
    if _bound is not None:
        return _bound
    with _build.lock(_LIB):
        if _bound is None:
            _bound = declare(_build.load_library(_LIB))
    return _bound


def step_kernel_attrs(rank: int, vec: bool = True) -> dict:
    """Kernel A's and kernel B's registers a thread, dynamic shared memory
    a block and resident blocks an SM at ``rank`` on the card (the 16-byte
    route when ``vec``; ``cudaFuncGetAttributes`` and the occupancy
    calculator)."""
    fn = _lib().dsgd_step_kernel_attrs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 6)()
    rc = fn(rank, int(vec), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"dsgd_step_kernel_attrs failed: CUDA error {rc}")
    return {f"{kernel}_{key}": out[3 * i + j]
            for i, kernel in enumerate(("a", "b"))
            for j, key in enumerate(("registers", "smem_bytes",
                                     "blocks_per_sm"))}


def validate_cuda_contract(updater, collision: str, has_inv: bool):
    """The routing contract of the CUDA kernels: they inline the λ/ω
    RegularizedSGDUpdater rule and consume the precomputed collision
    scales (the same ValueError as the JAX package's
    ``validate_pallas_contract``)."""
    missing = [a for a in ("learning_rate", "lambda_", "schedule")
               if not hasattr(updater, a)]
    if missing or collision != "mean" or not has_inv:
        raise ValueError(
            "the CUDA kernels inline the λ/ω RegularizedSGDUpdater rule "
            "and the precomputed collision scales; they require an updater "
            f"with learning_rate/lambda_/schedule (missing: {missing}), "
            "collision_mode='mean' and precompute_collisions=True")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on a CUDA device, False if every one lies
    on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors must all lie on one CUDA device or all on "
                     f"the CPU, got {sorted(kinds)}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _rule(lr: float, lam: float) -> RegularizedSGDUpdater:
    """The λ/ω rule the kernels inline, at a constant η = ``lr``."""
    return RegularizedSGDUpdater(learning_rate=lr, lambda_=lam,
                                 schedule=constant_lr)


# -- the step plan ----------------------------------------------------------


@dataclasses.dataclass(eq=False)
class StepPlan:
    """Each minibatch step's real (weight ≠ 0) entries, grouped by row.

    Step ``t = s·n_mb + g`` is minibatch g of all ``visits`` visits of
    stratum s (``num_blocks`` strata; ``visits`` is k on one device, 1 for
    one rank of the mesh).
    Its entries occupy positions ``entry_base[t]:entry_base[t+1]`` of the
    per-entry arrays, twice over:

    - in item order (``v_*``): grouped by V row, each group (an "item
      segment": one per row and step) in the minibatch's entry order, the
      step's segments visit by visit (visit 0 first), then by row;
    - in user order (``u_*``): the same by U row, the visits in reverse
      (``_visit_order``), with ``u_epos`` the entry's item-order position
      and ``u_vrow`` its item row.

    ``*_prow`` holds each position's row, as ``~row`` (negative) where its
    segment is longer than ``chunk``; those segments get a thread block
    each and are listed as ``[beg, end)`` position pairs in ``*_long``,
    cut by step at ``*_long_base``. Padding entries are in no segment.
    ``*_flag`` holds each position's touch flags for the bf16 route: its
    row's first (``FIRST``) and last (``LAST``) step among the stratum's
    real entries, and in item order the gathered user row's first
    (``GATHER_FIRST``); one byte a position and side. Host lists carry what
    the launches need.
    """

    num_blocks: int  # strata
    visits: int  # visits per stratum
    minibatch: int
    n_mb: int
    chunk: int
    rows_u: int  # the tables must hold at least these many rows
    rows_v: int
    low_u: int  # the lowest row a real entry names (0 without entries)
    low_v: int
    v_prow: torch.Tensor  # int32[R] item row (~row: long segment)
    v_su: torch.Tensor  # int32[R] user row of each entry, item order
    v_r: torch.Tensor  # f32[R]
    v_w: torch.Tensor
    v_icv: torch.Tensor
    v_long: torch.Tensor  # int32[Lv, 2] [beg, end) positions
    u_prow: torch.Tensor  # int32[R] user row (~row: long segment)
    u_epos: torch.Tensor  # int32[R] item-order position, user order
    u_vrow: torch.Tensor  # int32[R] item row of each entry, user order
    u_w: torch.Tensor
    u_icu: torch.Tensor
    u_long: torch.Tensor  # int32[Lu, 2]
    v_flag: torch.Tensor  # uint8[R] FIRST | LAST | GATHER_FIRST, item order
    u_flag: torch.Tensor  # uint8[R] FIRST | LAST, user order
    entry_base: list[int]
    v_long_base: list[int]
    u_long_base: list[int]
    v_segments: list[int]  # per step: its distinct item rows
    u_segments: list[int]
    longest_v: list[int]  # per step
    longest_u: list[int]
    v_touched: list[int]  # per stratum: its distinct item rows
    u_touched: list[int]
    _args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def steps(self) -> int:
        return self.num_blocks * self.n_mb

    @property
    def device(self) -> torch.device:
        return self.v_prow.device

    def check_step(self, t: int) -> None:
        if not 0 <= t < self.steps:
            raise ValueError(f"step {t} outside the plan's {self.steps}")

    def check_rows(self, rows_u: int, rows_v: int) -> None:
        """The row-range check of ``dsgd_train_cuda`` on the plan's host
        lists (no device read): the ValueError of ``_check_tables`` if a
        real entry names a row outside a table of ``rows_u`` / ``rows_v``
        rows (padding entries reach no kernel and are not checked)."""
        for name, low, top, rows in (("su", self.low_u, self.rows_u, rows_u),
                                     ("si", self.low_v, self.rows_v, rows_v)):
            if low < 0 or top > rows:
                raise ValueError(f"{name} holds rows outside [0, {rows})")

    def max_entries(self) -> int:
        return max(b - a for a, b in zip(self.entry_base,
                                         self.entry_base[1:]))

    def new_work(self, rank: int):
        """The step pair's buffers: ``e`` f32[max entries of a step] and
        the snapshot f32[item rows, rank] (v_old by item row)."""
        dev = self.device
        return (torch.empty(max(self.max_entries(), 1), dtype=torch.float32,
                            device=dev),
                torch.empty((max(self.rows_v, 1), rank), dtype=torch.float32,
                            device=dev))

    def nbytes(self) -> int:
        return sum(f.nbytes for f in (getattr(self, n.name) for n in
                                      dataclasses.fields(self))
                   if isinstance(f, torch.Tensor))

    def bound_bytes(self, rank: int, half: bool = False) -> int:
        """Device-memory bytes the step pair's function must move over the
        whole plan (one sweep): per step, each distinct row read and
        written once with its ω (f32), and 24 B of streams per real
        entry — the quantity the step's bound counts. ``half`` (bf16
        tables): each row's first read and last write of a stratum at 2 B
        a column, not 4."""
        row = rank * 4
        entries = self.entry_base[-1] - self.entry_base[0]
        rows = sum(self.u_segments) + sum(self.v_segments)
        saved = (sum(self.u_touched) + sum(self.v_touched)) * row if half \
            else 0
        return rows * (2 * row + 4) + entries * 24 - saved

    def flops(self, rank: int) -> int:
        """Operations of the step pair over the plan: 7·rank per entry in
        kernel A (dot, error, item delta), 5·rank in kernel B."""
        return (self.entry_base[-1] - self.entry_base[0]) * 12 * rank

    def _step_args(self, side: str, t: int, streams) -> tuple:
        key = (side, t)
        if key not in self._args:
            longs = getattr(self, f"{side}_long")
            base = getattr(self, f"{side}_long_base")
            self._args[key] = (
                *(a.data_ptr() for a in streams), self.entry_base[t],
                self.entry_base[t + 1], longs.data_ptr() + 8 * base[t],
                base[t + 1] - base[t], self.chunk)
        return self._args[key]

    def item_args(self, t: int) -> tuple:
        """Step ``t``'s plan arguments of ``sgd_item_rows_launch``."""
        return self._step_args("v", t, (self.v_prow, self.v_su, self.v_r,
                                        self.v_w, self.v_icv))

    def user_args(self, t: int) -> tuple:
        """Step ``t``'s plan arguments of ``sgd_user_rows_launch``."""
        return self._step_args("u", t, (self.u_prow, self.u_epos,
                                        self.u_vrow, self.u_w, self.u_icu))


def _bases(step_of: torch.Tensor, steps: int) -> torch.Tensor:
    """[steps + 1] start offsets of the step-sorted items ``step_of``."""
    counts = torch.bincount(step_of, minlength=steps)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def _visit_order(visit: torch.Tensor, visits: int):
    """The order of a step's visits in each kernel's walk: kernel A walks
    visit 0 first, kernel B the last visit first, so B starts on the U rows
    and snapshot rows A touched last (still in the L2)."""
    return visit, visits - 1 - visit


def _group(step, sub, rows, steps: int, subs: int, chunk: int):
    """Group entries (``step``, ``rows`` int64, in entry order) by (step,
    row) with a stable sort, a step's segments ordered by ``sub`` (< subs,
    one value per row and step), then by row. Returns the order, each
    position's row (``~row`` in a long segment), the long segments' [beg,
    end) positions and their step bases, and per step the segment count
    and the longest segment."""
    n = step.numel()
    dev = step.device
    # rows < 2^31: no host read for a row count (a negative row sorts
    # last, for StepPlan.check_rows to refuse)
    key = ((step * subs + sub) << 32) + (rows & 0xFFFFFFFF)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = skey[1:] != skey[:-1]
    first = torch.nonzero(new).squeeze(1)
    end = torch.cat([first[1:], first.new_full((1,), n)])
    length = end - first
    seg_step = (skey[first] >> 32) // subs
    is_long = length > chunk
    row = skey & 0xFFFFFFFF
    prow = torch.where(is_long.repeat_interleave(length), ~row, row)
    longest = torch.zeros(steps, dtype=torch.int64, device=dev)
    longest.scatter_reduce_(0, seg_step, length, "amax")
    return (order, prow, torch.stack([first[is_long], end[is_long]], 1),
            _bases(seg_step[is_long], steps),
            torch.bincount(seg_step, minlength=steps), longest)


def plan_entries(su, si, sw, minibatch: int):
    """The real (weight ≠ 0) entries of a layout ``[S, P, b]``: their flat
    slots, steps (``s·n_mb + g``), user rows and item rows (int64)."""
    P, b = int(su.shape[1]), int(su.shape[2])
    real = torch.nonzero(sw.reshape(-1) != 0).squeeze(1)
    step = (real // (P * b)) * (b // minibatch) + (real % b) // minibatch
    return (real, step, su.reshape(-1)[real].long(),
            si.reshape(-1)[real].long())


def touch_flags(step, rows, n_mb: int, strata: int, num_rows: int):
    """Per entry (``step``, ``rows`` int64 in ``[0, num_rows)``): FIRST
    where its step is its row's first among the stratum's entries, LAST
    where it is the last (stratum = step // n_mb); and each stratum's
    distinct rows. The first and last steps of each (stratum, row) go
    through a dense table of ``strata × num_rows`` cells (no host read)."""
    cell = (step // n_mb) * num_rows + rows
    first = torch.full((strata * num_rows,), strata * n_mb,
                       dtype=step.dtype, device=step.device)
    first.scatter_reduce_(0, cell, step, "amin")
    last = torch.full_like(first, -1).scatter_reduce_(0, cell, step, "amax")
    flags = ((step == first[cell]).to(torch.uint8) * FIRST
             | (step == last[cell]).to(torch.uint8) * LAST)
    return flags, (last.view(strata, num_rows) >= 0).sum(1)


def build_step_plan(su, si, sv, sw, icu, icv, *, minibatch: int) -> StepPlan:
    """The step plan of a layout ``[S, P, b]``: S strata of P row-disjoint
    visits, ``b`` a multiple of ``minibatch`` — the single-device
    stratum-major layout ``[k, k, b]`` (global rows), or one rank's
    device-major strata ``[k, 1, b]`` (block-local rows). Built with torch
    on the arrays' device and read back twice (each side's row range, for
    ``StepPlan.check_rows`` and to size the touch flags' tables; then the
    per-step bases and counts and each stratum's distinct rows). Stable
    sorts keep each segment in the minibatch's entry order, whatever
    ``minibatch_sort`` the layout was built with; a step's visits must be
    row-disjoint (as the blockings make them), or a row would get a segment
    in each visit."""
    if su.dim() != 3 or su.shape[-1] % minibatch:
        raise ValueError(f"su shape {tuple(su.shape)} is not [S, P, b] with "
                         f"b a multiple of {minibatch}")
    S, P, b = (int(d) for d in su.shape)
    if S * P * b >= 2 ** 31:
        raise ValueError("the plan indexes entries with int32: at most "
                         "2^31 − 1 slots")
    n_mb = b // minibatch
    steps = S * n_mb
    real, step, u_rows, i_rows = plan_entries(su, si, sw, minibatch)
    v_sub, u_sub = _visit_order((real // b) % P, P)
    v_order, v_prow, v_long, v_long_base, v_segs, longest_v = _group(
        step, v_sub, i_rows, steps, P, SEGMENT_CHUNK)
    u_order, u_prow, u_long, u_long_base, u_segs, longest_u = _group(
        step, u_sub, u_rows, steps, P, SEGMENT_CHUNK)
    v_pos = torch.empty_like(v_order)
    v_pos[v_order] = torch.arange(v_order.numel(), device=v_order.device)
    # each side's row range, read back first: it sizes the touch tables
    # (rows outside [0, top) are refused by StepPlan.check_rows; clamped
    # here, their flags are never read)
    sides = (u_rows, i_rows)
    top_u, top_v, low_u, low_v = torch.stack(
        [r.max() + 1 if r.numel() else r.new_zeros(()) for r in sides]
        + [r.min() if r.numel() else r.new_zeros(()) for r in sides]).tolist()
    u_touch, u_touched = touch_flags(step, u_rows.clamp(0, max(top_u - 1, 0)),
                                     n_mb, S, max(top_u, 1))
    v_touch, v_touched = touch_flags(step, i_rows.clamp(0, max(top_v - 1, 0)),
                                     n_mb, S, max(top_v, 1))
    gather_first = (u_touch & FIRST) * GATHER_FIRST  # FIRST is bit 0
    w = sw.reshape(-1)[real].float()
    parts = [_bases(step, steps), v_long_base, u_long_base, v_segs, u_segs,
             longest_v, longest_u, v_touched, u_touched]
    host = torch.cat(parts).cpu().tolist()
    lists, at = [], 0
    for part in parts:
        lists.append(host[at:at + part.numel()])
        at += part.numel()

    def i32(t):
        return t.to(torch.int32).contiguous()

    return StepPlan(
        num_blocks=S, visits=P, minibatch=minibatch, n_mb=n_mb,
        chunk=SEGMENT_CHUNK, rows_u=top_u, rows_v=top_v, low_u=low_u,
        low_v=low_v,
        v_prow=i32(v_prow),
        v_su=i32(u_rows[v_order]), v_r=sv.reshape(-1)[real][v_order].float(),
        v_w=w[v_order], v_icv=icv.reshape(-1)[real][v_order].float(),
        v_long=i32(v_long), u_prow=i32(u_prow), u_epos=i32(v_pos[u_order]),
        u_vrow=i32(i_rows[u_order]), u_w=w[u_order],
        u_icu=icu.reshape(-1)[real][u_order].float(), u_long=i32(u_long),
        v_flag=(v_touch | gather_first)[v_order].contiguous(),
        u_flag=u_touch[u_order].contiguous(),
        entry_base=lists[0], v_long_base=lists[1], u_long_base=lists[2],
        v_segments=lists[3], u_segments=lists[4], longest_v=lists[5],
        longest_u=lists[6], v_touched=lists[7], u_touched=lists[8])


# -- the step pair ----------------------------------------------------------


def plan_rows(prow: torch.Tensor) -> torch.Tensor:
    """The rows of ``*_prow`` positions (``~row`` decoded), as int64."""
    return torch.where(prow < 0, ~prow, prow).long()


def _flagged(flags: torch.Tensor, bit: int) -> torch.Tensor:
    return (flags & bit) != 0


def _first_reads(work, table16, rows, flags) -> None:
    """The bf16 route's reads of a row's first step: its bf16 value,
    upcast (exact), into the f32 work table."""
    first = rows[_flagged(flags, FIRST)]
    work[first] = table16[first].float()


def _last_writes(work, table16, rows, flags) -> None:
    """The bf16 route's writes of a row's last step: its work value
    rounded to bf16 (nearest even) into the bf16 table."""
    last = rows[_flagged(flags, LAST)]
    table16[last] = work[last].to(torch.bfloat16)


def sgd_item_rows_reference(U, V, omega_v, plan: StepPlan, t: int, work, *,
                            lr: float, lam: float, store=None):
    """Plain version of ``sgd_item_rows_kernel`` for step ``t``: fills
    ``e`` (per entry, item order) and the snapshot (each item row's old
    value, by row), and adds the item deltas into V in entry order.
    ``store``: the bf16 tables ``(U16, V16)`` of the work tables U and V
    (``v_flag`` says which reads come from them and which rows go back)."""
    e, snap = work
    e0, e1 = plan.entry_base[t], plan.entry_base[t + 1]
    rows = plan_rows(plan.v_prow[e0:e1])
    su = plan.v_su[e0:e1].long()
    if store is not None:
        flags = plan.v_flag[e0:e1]
        _first_reads(V, store[1], rows, flags)
        u = torch.where(_flagged(flags, GATHER_FIRST)[:, None],
                        store[0][su].float(), U[su])
    else:
        u = U[su]
    v = V[rows]
    w = plan.v_w[e0:e1]
    err = _errors(plan.v_r[e0:e1], u, v) * w
    _, dv = _rule(lr, lam).delta_from_errors(err, u, v, weights=w,
                                             omega_v=omega_v[rows])
    snap[rows] = v
    e[:e1 - e0] = err
    V.index_add_(0, rows, dv * plan.v_icv[e0:e1, None])
    if store is not None:
        _last_writes(V, store[1], rows, flags)
    return V


def sgd_user_rows_reference(U, omega_u, plan: StepPlan, t: int, work, *,
                            lr: float, lam: float, store=None):
    """Plain version of ``sgd_user_rows_kernel`` for step ``t``: adds the
    user deltas, from ``e`` and the snapshot, into U in entry order.
    ``store``: the bf16 tables ``(U16, V16)`` of the work tables (``u_flag``
    says which rows are read from U16 and which go back)."""
    e, snap = work
    e0, e1 = plan.entry_base[t], plan.entry_base[t + 1]
    rows = plan_rows(plan.u_prow[e0:e1])
    if store is not None:
        flags = plan.u_flag[e0:e1]
        _first_reads(U, store[0], rows, flags)
    u = U[rows]
    v = snap[plan.u_vrow[e0:e1].long()]
    err = e[plan.u_epos[e0:e1].long() - e0]
    du, _ = _rule(lr, lam).delta_from_errors(
        err, u, v, weights=plan.u_w[e0:e1], omega_u=omega_u[rows])
    U.index_add_(0, rows, du * plan.u_icu[e0:e1, None])
    if store is not None:
        _last_writes(U, store[0], rows, flags)
    return U


def _check_step(U, V, omega_u, omega_v, plan: StepPlan, work,
                store=None) -> int:
    """The step pair's operand checks (once per stratum on the sweep's
    path; ``store``: the bf16 tables beside the f32 work tables U and V);
    returns the rank."""
    rank = int(U.shape[-1]) if U.dim() == 2 else -1
    if U.dim() != 2 or V.dim() != 2 or V.shape[-1] != rank:
        raise ValueError(f"U {tuple(U.shape)} / V {tuple(V.shape)} must be "
                         "[rows, rank] with one rank")
    _check("U", U, torch.float32)
    _check("V", V, torch.float32)
    _check("omega_u", omega_u, torch.float32, (U.shape[0],))
    _check("omega_v", omega_v, torch.float32, (V.shape[0],))
    if U.shape[0] < plan.rows_u or V.shape[0] < plan.rows_v:
        raise ValueError(f"the plan reaches rows ({plan.rows_u}, "
                         f"{plan.rows_v}) outside U/V")
    e, snap = work
    _check("e", e, torch.float32)
    _check("snapshot", snap, torch.float32)
    if (e.numel() < plan.max_entries() or snap.dim() != 2
            or snap.shape[0] < plan.rows_v or snap.shape[1] != rank):
        raise ValueError("work buffers smaller than the plan's steps: use "
                         "plan.new_work(rank)")
    if plan.device != U.device:
        raise ValueError(f"plan on {plan.device}, tables on {U.device}")
    if store is not None:
        for name, t, like in (("U16", store[0], U), ("V16", store[1], V)):
            _check(name, t, torch.bfloat16, like.shape)
    top = _lib().dsgd_sweep_max_rank()
    if rank > top:
        raise ValueError(f"rank {rank} exceeds the kernels' {top}")
    return rank


def note_launches(plan: StepPlan, rank: int, sweeps: int, *,
                  half: bool = False) -> None:
    """Give the installed introspector (``obs.enable_introspection``) the
    step pair's record for ``sweeps`` sweeps over ``plan`` (``half``: on
    bf16 tables), against the enclosing span's compile key — the port's
    counterpart of the XLA cost analysis the JAX introspector reads. The
    step pair is all a sweep launches, in f32 and in bf16. One ``is not
    None`` test when introspection is off. Called once per segment by
    ``dsgd_train_cuda`` and by the mesh's per-visit route (one
    ``block_sweep`` call is one visit of a segment, so its caller notes
    the segment)."""
    introspector = get_introspector()
    if introspector is None:
        return
    introspector.note_compiled(
        introspector.current_key(_LIB), module=_LIB,
        flops=sweeps * plan.flops(rank),
        bytes_accessed=sweeps * plan.bound_bytes(rank, half))


def _launch(name: str, fn, args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _launch_item(lib, U, V, omega_v, plan, t, tail, store=None):
    if store is None:
        _launch("sgd_item_rows_kernel", lib.sgd_item_rows_launch,
                (U.data_ptr(), V.data_ptr(), omega_v.data_ptr())
                + plan.item_args(t) + tail)
    else:
        _launch("sgd_item_rows_kernel", lib.sgd_item_rows_bf16_launch,
                (U.data_ptr(), V.data_ptr(), store[0].data_ptr(),
                 store[1].data_ptr(), plan.v_flag.data_ptr(),
                 omega_v.data_ptr()) + plan.item_args(t) + tail)


def _launch_user(lib, U, omega_u, plan, t, tail, store=None):
    if store is None:
        _launch("sgd_user_rows_kernel", lib.sgd_user_rows_launch,
                (U.data_ptr(), omega_u.data_ptr()) + plan.user_args(t)
                + tail)
    else:
        _launch("sgd_user_rows_kernel", lib.sgd_user_rows_bf16_launch,
                (U.data_ptr(), store[0].data_ptr(), plan.u_flag.data_ptr(),
                 omega_u.data_ptr()) + plan.user_args(t) + tail)


def _tail(work, rank: int, lr: float, lam: float, device) -> tuple:
    e, snap = work
    return (e.data_ptr(), snap.data_ptr(), rank, float(lr), float(lam),
            torch.cuda.current_stream(device).cuda_stream)


def sgd_item_rows(U, V, omega_u, omega_v, plan: StepPlan, t: int, work, *,
                  lr: float, lam: float, store=None):
    """Kernel A of step ``t``: V rows updated in place, ``e`` and the
    snapshot filled (``work`` from ``plan.new_work``). η (``lr``) is a
    runtime scalar. ``store``: the bf16 tables ``(U16, V16)`` of which U
    and V are the f32 work tables (the bf16 route: a row is read from its
    bf16 table at its first step in the stratum and written back to it at
    its last)."""
    plan.check_step(t)
    if not _on_cuda(U, V, omega_u, omega_v, plan.v_prow, *work,
                    *(store or ())):
        return sgd_item_rows_reference(U, V, omega_v, plan, t, work, lr=lr,
                                       lam=lam, store=store)
    rank = _check_step(U, V, omega_u, omega_v, plan, work, store)
    _launch_item(_lib(), U, V, omega_v, plan, t,
                 _tail(work, rank, lr, lam, U.device), store)
    return V


def sgd_user_rows(U, V, omega_u, omega_v, plan: StepPlan, t: int, work, *,
                  lr: float, lam: float, store=None):
    """Kernel B of step ``t``: U rows updated in place from ``e`` and the
    snapshot that kernel A left in ``work`` (V is only checked);
    ``store`` as in ``sgd_item_rows``."""
    plan.check_step(t)
    if not _on_cuda(U, V, omega_u, omega_v, plan.v_prow, *work,
                    *(store or ())):
        return sgd_user_rows_reference(U, omega_u, plan, t, work, lr=lr,
                                       lam=lam, store=store)
    rank = _check_step(U, V, omega_u, omega_v, plan, work, store)
    _launch_user(_lib(), U, omega_u, plan, t,
                 _tail(work, rank, lr, lam, U.device), store)
    return U


def stratum_sweep(U, V, omega_u, omega_v, plan: StepPlan, s: int, work, *,
                  lr: float, lam: float, store=None):
    """Sweep stratum ``s`` (all k visits) in place: for each minibatch g,
    kernel A then kernel B of step ``s·n_mb + g``. The operands are checked
    once; each step is two bare launches. ``store``: the bf16 tables
    ``(U16, V16)`` of which U and V are the f32 work tables; they come out
    as one rounding of the stratum's work (``stratum_sweep_cast``'s tables,
    bit for bit), and the work tables hold nothing the next stratum
    reads."""
    plan.check_step(s * plan.n_mb)
    steps = range(s * plan.n_mb, (s + 1) * plan.n_mb)
    if not _on_cuda(U, V, omega_u, omega_v, plan.v_prow, *work,
                    *(store or ())):
        for t in steps:
            sgd_item_rows_reference(U, V, omega_v, plan, t, work, lr=lr,
                                    lam=lam, store=store)
            sgd_user_rows_reference(U, omega_u, plan, t, work, lr=lr,
                                    lam=lam, store=store)
        return U, V
    rank = _check_step(U, V, omega_u, omega_v, plan, work, store)
    lib = _lib()
    tail = _tail(work, rank, lr, lam, U.device)
    for t in steps:
        _launch_item(lib, U, V, omega_v, plan, t, tail, store)
        _launch_user(lib, U, omega_u, plan, t, tail, store)
    return U, V


def stratum_sweep_cast(U16, V16, Uw, Vw, omega_u, omega_v, plan: StepPlan,
                       s: int, work, *, lr: float, lam: float):
    """Stratum ``s`` on bf16 tables by the earlier route, kept as the
    baseline the flagged route (``stratum_sweep(..., store=)``) is held
    against: ``bf16_to_f32`` upcasts both whole tables into the f32 work
    tables ``Uw``/``Vw``, the f32 pair sweeps them, ``f32_to_bf16`` rounds
    both back. No path of the port calls it. Returns ``(U16, V16)``."""
    bf16_to_f32(U16, V16, Uw, Vw)
    stratum_sweep(Uw, Vw, omega_u, omega_v, plan, s, work, lr=lr, lam=lam)
    return f32_to_bf16(Uw, Vw, U16, V16)


def block_sweep(U_blk, V_blk, omega_u, omega_v, plan: StepPlan, s: int, work,
                *, lr: float, lam: float):
    """One rank's visit ``s`` on the mesh (counterpart of
    ``pallas_block_sweep``): rating block (p, (p+s) mod k) swept against the
    rank's block-local tables ``U_blk``/``V_blk`` (f32 or bf16) and their
    per-row ω, in place; returns them. ``plan`` is ``build_step_plan`` of
    the rank's device-major strata as ``[k, 1, b]`` (built once per fit),
    ``work`` its ``plan.new_work(rank)``, η (``lr``) a runtime scalar.

    On CUDA tensors the step pair runs the visit's ``n_mb`` steps; bf16
    tables stay the storage of f32 work tables from the caching allocator
    (``stratum_sweep(..., store=)``: one rounding per visit, the TPU
    kernel's cadence, and no cast launch). On CPU tensors the same plan
    runs through the step pair's plain versions. The step pair holds full
    factor rows: rank-sharded tables do not reach it (``MeshDSGD`` refuses
    them). The introspector's record is its caller's (``note_launches``,
    once per segment)."""
    if plan.visits != 1:
        raise ValueError(f"block_sweep takes a plan of one visit per stratum "
                         f"([k, 1, b]); this one has {plan.visits}")
    if U_blk.dtype != torch.bfloat16:
        stratum_sweep(U_blk, V_blk, omega_u, omega_v, plan, s, work, lr=lr,
                      lam=lam)
        return U_blk, V_blk
    # the visit's f32 work tables (from the caching allocator: no sync)
    Uw = torch.empty(U_blk.shape, dtype=torch.float32, device=U_blk.device)
    Vw = torch.empty(V_blk.shape, dtype=torch.float32, device=V_blk.device)
    stratum_sweep(Uw, Vw, omega_u, omega_v, plan, s, work, lr=lr, lam=lam,
                  store=(U_blk, V_blk))
    return U_blk, V_blk


# -- the bf16 casts ---------------------------------------------------------


def _check_cast(src, dst, src_dtype, dst_dtype):
    for name, t, dt in (("U src", src[0], src_dtype),
                        ("V src", src[1], src_dtype),
                        ("U dst", dst[0], dst_dtype),
                        ("V dst", dst[1], dst_dtype)):
        _check(name, t, dt)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for a, b in zip(src, dst):
        if a.shape != b.shape:
            raise ValueError(f"cast shapes differ: {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")


def _cast(kernel: str, src, dst, src_dtype, dst_dtype):
    """Launch one of the two cast kernels over both tables."""
    _check_cast(src, dst, src_dtype, dst_dtype)
    stream = torch.cuda.current_stream(src[0].device).cuda_stream
    launch = getattr(_lib(), kernel.replace("_kernel", "_launch"))
    _launch(kernel, launch, (src[0].data_ptr(), dst[0].data_ptr(),
                             src[0].numel(), src[1].data_ptr(),
                             dst[1].data_ptr(), src[1].numel(), stream))


def bf16_to_f32(Ub, Vb, U32, V32):
    """Fill the f32 work tables ``U32``/``V32`` from the bf16 tables (one
    launch for both; exact)."""
    if not _on_cuda(Ub, Vb, U32, V32):
        _check_cast((Ub, Vb), (U32, V32), torch.bfloat16, torch.float32)
        U32.copy_(Ub)
        V32.copy_(Vb)
        return U32, V32
    _cast("bf16_to_f32_kernel", (Ub, Vb), (U32, V32), torch.bfloat16,
          torch.float32)
    return U32, V32


def f32_to_bf16(U32, V32, Ub, Vb):
    """Round the f32 work tables into the bf16 tables ``Ub``/``Vb`` (one
    launch for both; round to nearest even)."""
    if not _on_cuda(U32, V32, Ub, Vb):
        _check_cast((U32, V32), (Ub, Vb), torch.float32, torch.bfloat16)
        Ub.copy_(U32)
        Vb.copy_(V32)
        return Ub, Vb
    _cast("f32_to_bf16_kernel", (U32, V32), (Ub, Vb), torch.float32,
          torch.bfloat16)
    return Ub, Vb


# -- the training loop ------------------------------------------------------


def _check_layout(U, V, su, minibatch: int, k: int):
    """The layout checks ``dsgd_train_cuda`` and its plain twin share (no
    device read)."""
    if U.dtype != V.dtype or U.dtype not in FACTOR_DTYPES:
        raise ValueError(f"factor dtypes {U.dtype}/{V.dtype} unsupported; "
                         "both float32 or both bfloat16")
    if int(U.shape[0]) % k or int(V.shape[0]) % k:
        raise ValueError(
            f"table rows ({U.shape[0]}, {V.shape[0]}) must be divisible "
            f"by num_blocks={k} — use the data.blocking layout")
    if tuple(su.shape[:2]) != (k, k) or su.shape[-1] % minibatch:
        raise ValueError(f"su shape {tuple(su.shape)} is not [{k}, {k}, b] "
                         f"with b a multiple of {minibatch}")


def _check_tables(U, V, su, si, minibatch: int, k: int):
    """The layout checks and the row ranges of every entry (two reductions
    read back a side: the plain twin's checks)."""
    _check_layout(U, V, su, minibatch, k)
    for name, idx, rows in (("su", su, U.shape[0]), ("si", si, V.shape[0])):
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= rows):
            raise ValueError(f"{name} holds rows outside [0, {rows})")


def _lr_at(lr: float, schedule, t: int) -> float:
    """η of sweep ``t`` (1-based), evaluated on the host."""
    return float(np.float32(lr)) if schedule is None else schedule(lr, t)


def dsgd_train_cuda(
    U: torch.Tensor,  # f32|bf16[k*rpb_u, r]
    V: torch.Tensor,  # f32|bf16[k*rpb_v, r]
    su: torch.Tensor,  # int32[k, k, b] stratum-major GLOBAL user rows
    si: torch.Tensor,
    sv: torch.Tensor,
    sw: torch.Tensor,
    omega_u: torch.Tensor,  # f32[k*rpb_u]
    omega_v: torch.Tensor,
    icu: torch.Tensor,  # precomputed collision scales [k, k, b]
    icv: torch.Tensor,
    *,
    lr: float,
    lam: float,
    minibatch: int,
    num_blocks: int,
    iterations: int,
    schedule=None,
    t0: int = 0,
    plan: StepPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full DSGD training through the stratum-sweep kernels (counterpart of
    ``dsgd_train_pallas``; same positional layout as ``ops.sgd.dsgd_train``).

    Visit order: for each sweep, strata s = 0..k−1. The schedule is
    evaluated on the host once per sweep at ``t = sweep + 1 + t0`` and η
    enters the kernel as a runtime scalar (``schedule=None`` keeps η
    constant). ``plan`` is ``build_step_plan`` of these arrays (built here
    when absent); the rows are checked on its host lists, so the call reads
    nothing back from the device when a plan is given. Returns trained
    copies of U and V.

    bf16 tables: the step pair reads each row from its bf16 table at the
    row's first step of a stratum and writes it back at its last, through
    one f32 work table a side allocated here (the TPU kernels' one
    downcast per visit; no cast launch).
    """
    k = num_blocks
    _check_layout(U, V, su, minibatch, k)
    if plan is None:
        plan = build_step_plan(su, si, sv, sw, icu, icv, minibatch=minibatch)
    elif (plan.num_blocks, plan.visits, plan.minibatch) != (k, k, minibatch):
        raise ValueError(f"plan of {plan.num_blocks} strata × {plan.visits} "
                         f"visits, minibatch {plan.minibatch}; expected "
                         f"{k} × {k}, {minibatch}")
    # the kernels read only the plan: its host lists bound the rows
    plan.check_rows(int(U.shape[0]), int(V.shape[0]))
    U = U.clone()
    V = V.clone()
    half = U.dtype == torch.bfloat16
    # the step kernels' tables: in bf16, f32 work tables beside the storage
    Uw, Vw = ((torch.empty(U.shape, dtype=torch.float32, device=U.device),
               torch.empty(V.shape, dtype=torch.float32, device=V.device))
              if half else (U, V))
    store = (U, V) if half else None
    work = plan.new_work(int(U.shape[-1]))
    for sweep in range(iterations):
        lr_t = _lr_at(lr, schedule, sweep + 1 + int(t0))
        for s in range(k):
            stratum_sweep(Uw, Vw, omega_u, omega_v, plan, s, work, lr=lr_t,
                          lam=lam, store=store)
    note_launches(plan, int(U.shape[-1]), iterations, half=half)
    return U, V


def dsgd_train_reference(U, V, su, si, sv, sw, omega_u, omega_v, icu, icv,
                         *, lr: float, lam: float, minibatch: int,
                         num_blocks: int, iterations: int, schedule=None,
                         t0: int = 0):
    """Plain twin of ``dsgd_train_cuda`` on any device: the same visit
    order and host schedule, each stratum swept by ``ops.sgd`` on an f32
    copy of the tables and rounded back to their dtype at its end (the
    kernels' rounding points in bf16; exact in f32). Returns trained
    copies."""
    k = num_blocks
    _check_tables(U, V, su, si, minibatch, k)
    store = U.dtype
    b = su.shape[-1]
    flat = [a.reshape(k, k * b) for a in (su, si, sv, sw, icu, icv)]
    Uw = U.to(torch.float32, copy=True)
    Vw = V.to(torch.float32, copy=True)
    for sweep in range(iterations):
        rule = _rule(_lr_at(lr, schedule, sweep + 1 + int(t0)), lam)
        for s in range(k):
            fs, fi, fv, fw, fcu, fcv = (a[s] for a in flat)
            sgd_ops.sgd_block_sweep(Uw, Vw, fs, fi, fv, fw, omega_u, omega_v,
                                    rule, 1, minibatch, "mean", fcu, fcv)
            if store != torch.float32:
                Uw.copy_(Uw.to(store))
                Vw.copy_(Vw.to(store))
    return Uw.to(store), Vw.to(store)


# -- plain versions of the TPU kernels' own contracts -----------------------


def build_stratum_operands(su, si, sv, sw, icu, icv, omega_u, omega_v,
                           *, num_blocks: int, rpb_u: int, rpb_v: int,
                           minibatch: int):
    """The visit-major operand layout of ``pallas_stratum_sweep`` from the
    stratum-major arrays: block-LOCAL row indices ``idx [k², 2, b]`` and
    the stacked per-entry streams ``streams [k², rows6, mb]`` (vals, w,
    icu, icv, ω_u, ω_v, each ``n_mb`` rows, padded to a multiple of 8).
    Weight-0 padding entries carry global row 0, a negative local row for
    blocks p > 0: it is clamped to 0, as in the JAX package."""
    k = num_blocks
    b = int(su.shape[-1])
    n_mb = b // minibatch
    dev = su.device
    p_arr = torch.arange(k, dtype=torch.int64, device=dev)
    q_arr = (p_arr[None, :] + p_arr[:, None]) % k
    ur_l = (su.long() - (p_arr * rpb_u)[None, :, None]).clamp_min(0)
    ir_l = (si.long() - (q_arr * rpb_v)[:, :, None]).clamp_min(0)
    idx = torch.stack([ur_l.reshape(k * k, b), ir_l.reshape(k * k, b)],
                      dim=1).to(torch.int32)
    ou_e = omega_u.float()[su.long()]
    ov_e = omega_v.float()[si.long()]
    streams = torch.stack([a.float() for a in (sv, sw, icu, icv, ou_e, ov_e)],
                          dim=2)  # [k, k, 6, b]
    streams = streams.reshape(k * k, 6 * n_mb, minibatch)
    rows6 = -(-6 * n_mb // 8) * 8
    if rows6 != 6 * n_mb:
        streams = torch.nn.functional.pad(
            streams, (0, 0, 0, rows6 - 6 * n_mb))
    return idx, streams


def block_sweep_reference(U_blk, V_blk, ur_local, ir_local, vals, w, icu, icv,
                          omega_u, omega_v, *, lr: float, lam: float,
                          minibatch: int):
    """Plain version of ``pallas_block_sweep`` (``_sweep_kernel``): sweep one
    rating block against its block-local U/V row slices and ω. Returns
    updated copies in the input dtype (bf16: one f32 work copy, one
    downcast at the visit's end)."""
    Ub = U_blk.to(torch.float32, copy=True)
    Vb = V_blk.to(torch.float32, copy=True)
    sgd_ops.sgd_block_sweep(
        Ub, Vb, ur_local, ir_local, vals, w, omega_u, omega_v,
        _rule(lr, lam), 1, minibatch, "mean", icu, icv)
    return Ub.to(U_blk.dtype), Vb.to(V_blk.dtype)


def _block_omega(rows, omega_e, w, rpb):
    """A block's ω slice from the per-entry ω stream: every real entry of a
    row carries that row's ω (padding entries carry another block's)."""
    real = w != 0
    out = torch.zeros(rpb, dtype=omega_e.dtype, device=omega_e.device)
    out[rows[real].long()] = omega_e[real]
    return out


def stratum_sweep_reference(U, V, idx, streams, s: int, *, lr: float,
                            lam: float, minibatch: int, num_blocks: int):
    """Plain version of ``pallas_stratum_sweep`` (``_stratum_kernel``):
    visits p = 0..k−1 of stratum ``s`` in order (U block p, V block
    (p+s) mod k), from ``build_stratum_operands``' layout. Returns updated
    copies in the input dtype (bf16: each visit sweeps an f32 copy of its
    slices and rounds it back once)."""
    k = num_blocks
    rpb_u = U.shape[0] // k
    rpb_v = V.shape[0] // k
    n_mb = idx.shape[-1] // minibatch
    U, V = U.clone(), V.clone()
    for p in range(k):
        q = (p + s) % k
        vrow = s * k + p
        vals, w, icu, icv, ou_e, ov_e = (
            streams[vrow, c * n_mb:(c + 1) * n_mb].reshape(-1)
            for c in range(6))
        ur, ir = idx[vrow, 0], idx[vrow, 1]
        Us = U[p * rpb_u:(p + 1) * rpb_u]
        Vs = V[q * rpb_v:(q + 1) * rpb_v]
        # the visit's f32 work slices (views of the copies in f32 mode)
        Uw, Vw = Us.to(torch.float32), Vs.to(torch.float32)
        sgd_ops.sgd_block_sweep(
            Uw, Vw, ur, ir, vals, w, _block_omega(ur, ou_e, w, rpb_u),
            _block_omega(ir, ov_e, w, rpb_v), _rule(lr, lam), 1, minibatch,
            "mean", icu, icv)
        if Uw is not Us:
            Us.copy_(Uw)
            Vs.copy_(Vw)
    return U, V


# -- the variant probe ------------------------------------------------------

PROBE_VARIANTS = ("torch", "cuda")
# the JAX package's variants and their counterparts here
_JAX_VARIANTS = {"xla": "torch", "pallas_take": "cuda", "pallas_loop": "cuda"}


class ProbeRates(dict):
    """``probe_variants``' result, ``{variant: ratings/s | "FAILED <type>:
    <msg>"}``, with the cuda variant's plan build wall in ``plan_s``
    (seconds; ``None`` when that variant did not build its plan)."""

    plan_s: float | None = None


def _probe_inputs(gen: torch.Generator, rank: int, mb: int, rpb_u: int,
                  rpb_v: int, e: int, sort: bool):
    """The probe's (stratum, block) visit, drawn on ``gen``'s device (the
    counterpart of the JAX ``_probe_inputs``): ``e`` entries of block-local
    user and item rows from the truncated exponential at λ 2 (each
    minibatch sorted by user row when ``sort``), normal ratings, unit
    weights, the per-minibatch collision scales, ω = max(count, 1) and
    tables of 0.1·N(0, 1). Returns ``(ur, ir, vals, w, icu, icv, ou, ov, U,
    V)``."""
    dev = gen.device
    ur = truncated_exp_ids(gen, 2.0, rpb_u, e)
    ir = truncated_exp_ids(gen, 2.0, rpb_v, e)
    if sort:
        order = torch.argsort(ur.view(-1, mb), dim=1, stable=True)
        ur = torch.gather(ur.view(-1, mb), 1, order).reshape(-1)
        ir = torch.gather(ir.view(-1, mb), 1, order).reshape(-1)
    vals = torch.randn(e, generator=gen, device=dev)
    w = torch.ones(e, device=dev)
    U = 0.1 * torch.randn((rpb_u, rank), generator=gen, device=dev)
    V = 0.1 * torch.randn((rpb_v, rank), generator=gen, device=dev)

    def omega(rows, n):
        return torch.zeros(n, device=dev).index_add_(
            0, rows, w).clamp_min(1.0)

    def inv(rows):
        return _inv_counts_2d(rows.view(-1, mb), w.view(-1, mb)).reshape(-1)

    return (ur.int(), ir.int(), vals, w, inv(ur), inv(ir), omega(ur, rpb_u),
            omega(ir, rpb_v), U, V)


def _probe_setups(inputs, *, mb: int, sweeps: int, lr: float, lam: float,
                  rates: ProbeRates) -> dict:
    """Per variant, a setup that returns the variant's timed call (``sweeps``
    visits of ``inputs``, from ``_probe_inputs``, on copies of its tables;
    returns them): ``"torch"`` sweeps with ``ops.sgd.sgd_block_sweep``,
    ``"cuda"`` builds its one-visit plan (its wall into ``rates.plan_s``)
    and runs ``block_sweep``."""
    ur, ir, vals, w, icu, icv, ou, ov, U0, V0 = inputs
    e = ur.numel()

    def torch_variant():
        rule = _rule(lr, lam)

        def run():
            U, V = U0.clone(), V0.clone()
            for _ in range(sweeps):
                sgd_ops.sgd_block_sweep(U, V, ur, ir, vals, w, ou, ov, rule,
                                        1, mb, "mean", icu, icv)
            return U, V

        return run

    def cuda_variant():
        t0 = time.perf_counter()
        plan = build_step_plan(*(a.view(1, 1, e) for a in
                                 (ur, ir, vals, w, icu, icv)), minibatch=mb)
        rates.plan_s = time.perf_counter() - t0  # ends in a host read
        work = plan.new_work(int(U0.shape[-1]))

        def run():
            U, V = U0.clone(), V0.clone()
            for _ in range(sweeps):
                block_sweep(U, V, ou, ov, plan, 0, work, lr=lr, lam=lam)
            return U, V

        return run

    return {"torch": torch_variant, "cuda": cuda_variant}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def probe_variants(rank: int = 128, mb: int = 2048, rpb_u: int = 5080,
                   rpb_v: int = 1848, nnz: int = 24576, reps: int = 5,
                   seed: int = 0, sort: bool = False, sweeps: int = 1,
                   variants: tuple = PROBE_VARIANTS,
                   device=None) -> ProbeRates:
    """Measure the framework's own sweep (``"torch"``, the JAX ``"xla"``)
    against the step pair (``"cuda"``, the JAX Pallas variants) on ONE
    realistic (stratum, block) visit, drawn on the device from ``seed``
    (the JAX defaults: one ML-25M block visit at k = 32). Returns
    ``{variant: ratings_per_s | "FAILED <type>: <msg>"}`` (a ``ProbeRates``,
    with the cuda variant's plan build wall in ``plan_s``): a variant that
    raises is recorded, not hidden. A JAX variant name raises a
    ``ValueError`` naming its counterpart. ``device=None`` runs on the card.

    Each variant's first call (the cuda variant's plan build included) is
    the warm-up; then ``reps`` timed calls, each ``sweeps`` visits in a loop
    with one sync at the end (``sweeps`` ≥ 16 amortizes the launch and the
    sync). With obs on: a ``pallas_probe/<variant>`` span per call
    (compile-keyed, so the warm-up reads "compile"), and the JAX metrics
    ``pallas_probe_ratings_per_s{variant,rank,sorted}``,
    ``pallas_probe_sweep_s{variant}`` and
    ``pallas_probe_failures_total{variant}``."""
    for label in variants:
        if label not in PROBE_VARIANTS:
            hint = _JAX_VARIANTS.get(label)
            raise ValueError(
                f"unknown probe variant {label!r}"
                + (f" (the JAX package's; here it is {hint!r})"
                   if hint else "") + f": expected one of {PROBE_VARIANTS}")
    dev = resolve_device(device)
    e = nnz - nnz % mb
    lr, lam = 0.1, 0.1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    inputs = _probe_inputs(gen, rank, mb, rpb_u, rpb_v, e, sort)
    out = ProbeRates()
    setups = _probe_setups(inputs, mb=mb, sweeps=sweeps, lr=lr, lam=lam,
                               rates=out)
    obs = get_registry()
    tracer = get_tracer()
    sort_lbl = str(bool(sort)).lower()
    for label in variants:
        key = ("pallas_probe", label, rank, mb, sort)
        try:
            with tracer.span(f"pallas_probe/{label}", key=key, rank=rank,
                             mb=mb):
                fn = setups[label]()
                fn()
                _sync(dev)  # a deferred device error surfaces in this try
        except Exception as ex:
            out[label] = f"FAILED {type(ex).__name__}: {str(ex)[:200]}"
            if obs.enabled:
                obs.counter("pallas_probe_failures_total",
                            variant=label).inc()
            continue
        walls = []
        for _ in range(reps):
            with tracer.span(f"pallas_probe/{label}", key=key, rank=rank,
                             mb=mb):
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                walls.append(time.perf_counter() - t0)
        out[label] = round(e * sweeps / min(walls), 1)
        if obs.enabled:
            obs.gauge("pallas_probe_ratings_per_s", variant=label,
                      rank=rank, sorted=sort_lbl).set(out[label])
            for wall in walls:
                obs.histogram("pallas_probe_sweep_s",
                              variant=label).observe(wall / sweeps)
    return out
