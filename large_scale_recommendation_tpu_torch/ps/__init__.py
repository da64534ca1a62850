"""Parameter-server execution mode (counterpart of
``large_scale_recommendation_tpu.ps``): host threads and queues around
torch updates on the workers' devices.

- ``core``      — the client / worker logic / server logic protocols and
                  the wire dataclasses
- ``server``    — the default host-table shard and the ``abs(id) % P``
                  sharded store
- ``transform`` — ``ps_transform``: workers and shards as a running async
                  topology
- ``mf``        — PS-based offline MF (``PSOfflineMF``)
- ``adaptive``  — online + periodic-batch MF with the Online / BatchInit /
                  Batch state machines (``PSOnlineBatchMF``)
"""

from large_scale_recommendation_tpu_torch.ps.adaptive import (
    BATCH_TRIGGER,
    PSOnlineBatchConfig,
    PSOnlineBatchMF,
)
from large_scale_recommendation_tpu_torch.ps.core import (
    ParameterServerClient,
    ParameterServerLogic,
    WorkerLogic,
)
from large_scale_recommendation_tpu_torch.ps.server import SimplePSLogic
from large_scale_recommendation_tpu_torch.ps.transform import (
    PSTopology,
    ps_transform,
)

__all__ = [
    "BATCH_TRIGGER",
    "ParameterServerClient",
    "ParameterServerLogic",
    "PSOnlineBatchConfig",
    "PSOnlineBatchMF",
    "SimplePSLogic",
    "WorkerLogic",
    "PSTopology",
    "ps_transform",
]
