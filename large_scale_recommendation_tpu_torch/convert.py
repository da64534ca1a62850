"""Carry weights from the JAX package into the port.

Both take plain numpy arrays (``np.asarray`` of the JAX arrays) and duck-typed
``IdIndex``-like objects, so nothing here imports JAX. bf16 tables may come
as ``bfloat16`` numpy arrays (ml_dtypes) or as their ``uint16``/``int16``
bit views; they stay bf16.
"""

from __future__ import annotations

import numpy as np
import torch

from large_scale_recommendation_tpu_torch.data.blocking import IdIndex
from large_scale_recommendation_tpu_torch.models.mf import MFModel


def _table(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the port trains its tables in place
    if a.dtype == np.float32:
        t = torch.from_numpy(a)
    elif a.dtype.name == "bfloat16" or a.dtype in (np.uint16, np.int16):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        raise ValueError(f"factor table dtype {a.dtype} unsupported; "
                         "float32 or bfloat16 (or its 16-bit view)")
    return t.to(device)


def factors_from_jax(U, V, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """JAX-package factor tables (numpy) → torch tables on ``device``."""
    return _table(U, device), _table(V, device)


def _index(ix) -> IdIndex:
    return IdIndex(
        ids=np.asarray(ix.ids, np.int64),
        num_blocks=int(ix.num_blocks),
        rows_per_block=int(ix.rows_per_block),
        omega=np.asarray(ix.omega, np.float32),
        sorted_ids=np.asarray(ix.sorted_ids, np.int64),
        sorted_rows=np.asarray(ix.sorted_rows, np.int64),
    )


def model_from_jax(U, V, users, items, device="cpu") -> MFModel:
    """The port's ``MFModel`` from a JAX model's tables and its two
    ``IdIndex`` objects (any objects with the same fields)."""
    U, V = factors_from_jax(U, V, device)
    return MFModel(U=U, V=V, users=_index(users), items=_index(items))
