"""The three collectives the mesh needs, over ``torch.distributed``.

The JAX package writes them inside ``shard_map`` as ``jax.lax`` calls; here
each is a plain function over one axis of the rank grid (``Axis``: the
axis's ranks in order, this rank's position, and its process group):

    lax.ppermute(x, axis, ring_backward)   ring_shift   batch_isend_irecv,
                                                        shard j → j−1
    lax.psum(x, axis)                      group_sum    all_reduce (SUM)
    lax.all_gather(x, axis, tiled=True)    gather       all_gather into one
                                                        preallocated tensor
    (XLA's global sort/scatter)            exchange     all-to-all of rows,
                                                        batch_isend_irecv

On an axis of size 1 each is the identity, as ``ppermute`` with the
identity permutation is: nothing is sent to self. bf16 tensors travel as
their bytes (a uint8 view: gloo's typed transports take no bf16 or int16,
and no collective here reduces one).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the rank grid as seen from this rank. ``group`` is the
    axis's process group; ``None`` with ``size > 1`` means the default
    (world) group."""

    name: str
    ranks: tuple[int, ...]  # global ranks along the axis, in axis order
    index: int  # this rank's position on the axis
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def ring_shift(axis: Axis, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Rotate each tensor one step down the ring: position j's tensor moves
    to position j−1 (mod size), so this rank receives position j+1's
    (``lax.ppermute`` with ``ring_backward``). Returns new tensors."""
    if axis.size == 1:
        return list(tensors)
    dst = axis.ranks[(axis.index - 1) % axis.size]
    src = axis.ranks[(axis.index + 1) % axis.size]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, _wire(t.contiguous()), dst,
                              group=axis.group))
        ops.append(dist.P2POp(dist.irecv, _wire(o), src, group=axis.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


def group_sum(axis: Axis, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the axis (``lax.psum``), written into ``t``
    and returned."""
    if axis.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def gather(axis: Axis, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every position's ``t`` concatenated along ``dim`` in axis order
    (``lax.all_gather(..., tiled=True)``): one ``all_gather`` into a
    preallocated ``[size, *t.shape]`` tensor, then the concatenation."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    out = torch.empty((axis.size, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(_wire(out).unbind(0)), _wire(t), group=axis.group)
    return torch.cat(out.unbind(0), dim=dim)


def exchange(axis: Axis, tensors, dest: torch.Tensor) -> list[torch.Tensor]:
    """All-to-all of rows: row j of every tensor goes to position
    ``dest[j]`` of the axis. Returns, per tensor, the rows this position
    received, ordered by sender position and, within a sender, by the
    sender's row order. The counts travel first (a gather), then one
    ``batch_isend_irecv`` of every non-empty chunk."""
    if axis.size == 1:
        return list(tensors)
    order = torch.argsort(dest, stable=True)
    sent = torch.bincount(dest, minlength=axis.size)
    counts = gather(axis, sent[None], dim=0).cpu()  # [from, to]
    send = sent.cpu().tolist()
    recv = counts[:, axis.index].tolist()
    outs, ops = [], []
    for t in tensors:
        src = t[order].contiguous()
        out = torch.empty((sum(recv), *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        outs.append(out)
        s_at = r_at = 0
        for q, peer in enumerate(axis.ranks):
            a, b = src[s_at:s_at + send[q]], out[r_at:r_at + recv[q]]
            if q == axis.index:
                b.copy_(a)
            else:
                if send[q]:
                    ops.append(dist.P2POp(dist.isend, _wire(a), peer,
                                          group=axis.group))
                if recv[q]:
                    ops.append(dist.P2POp(dist.irecv, _wire(b), peer,
                                          group=axis.group))
            s_at += send[q]
            r_at += recv[q]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs
