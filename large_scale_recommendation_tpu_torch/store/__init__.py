"""Tiered factor store (counterpart of ``large_scale_recommendation_tpu
.store``): a host cold tier (pinned on a card) behind a fixed device slot
pool, with asynchronous WAL-lookahead prefetch."""

from large_scale_recommendation_tpu_torch.store.prefetch import (
    StorePrefetcher,
)
from large_scale_recommendation_tpu_torch.store.tiered import (
    StoreStats,
    TieredFactorStore,
)

__all__ = ["TieredFactorStore", "StoreStats", "StorePrefetcher"]
