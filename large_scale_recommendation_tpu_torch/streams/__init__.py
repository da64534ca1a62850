"""Durable streaming ingest runtime (counterpart of
``large_scale_recommendation_tpu.streams``): a partitioned event log,
backpressure sources, the crash-recovering online → serve driver and the
N-consumer parallel runner.

    log      partitioned append-only WAL (fixed-size segments, acked
             appends, offset-range reads, retention)
    sources  offset-stamped micro-batches through a bounded queue
             (block / drop / dead-letter), poison quarantine
    driver   StreamingDriver: log → OnlineMF/AdaptiveMF → ServingEngine,
             the consumed offset checkpointed with (U, V, step)
    parallel ParallelIngestRunner: N per-partition consumers over one
             model, row-disjoint concurrent applies, a cross-partition
             checkpoint barrier, coalesced delta shipping
"""

from large_scale_recommendation_tpu_torch.streams.driver import (
    StreamingDriver,
    StreamingDriverConfig,
)
from large_scale_recommendation_tpu_torch.streams.log import (
    EventLog,
    LogTruncatedError,
)
from large_scale_recommendation_tpu_torch.streams.parallel import (
    ParallelIngestRunner,
    RowConflictGate,
    append_routed,
    route_partition,
)
from large_scale_recommendation_tpu_torch.streams.sources import (
    CSVSource,
    DeadLetterBuffer,
    GeneratorSource,
    IngestQueue,
    LogTailSource,
    QueuedSource,
    StreamBatch,
    pump_to_log,
    split_poison,
)

__all__ = [
    "CSVSource",
    "DeadLetterBuffer",
    "EventLog",
    "GeneratorSource",
    "IngestQueue",
    "LogTailSource",
    "LogTruncatedError",
    "ParallelIngestRunner",
    "QueuedSource",
    "RowConflictGate",
    "StreamBatch",
    "StreamingDriver",
    "StreamingDriverConfig",
    "append_routed",
    "pump_to_log",
    "route_partition",
    "split_poison",
]
