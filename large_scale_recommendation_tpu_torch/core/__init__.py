"""Engine-agnostic math contract: ratings batches, schedules and updaters,
factor initializers, synthetic workload generators (counterpart of
``large_scale_recommendation_tpu.core``, exporting the same names)."""

from large_scale_recommendation_tpu_torch.core.generators import (
    DiscreteExponentialGenerator,
    ExponentialRatingGenerator,
    UniformRatingGenerator,
)
from large_scale_recommendation_tpu_torch.core.initializers import (
    FactorInitializer,
    PseudoRandomFactorInitializer,
    RandomFactorInitializer,
)
from large_scale_recommendation_tpu_torch.core.limiter import (
    ThroughputLimiter,
)
from large_scale_recommendation_tpu_torch.core.types import (
    FactorVector,
    ItemUpdate,
    Ratings,
    UserUpdate,
)
from large_scale_recommendation_tpu_torch.core.updaters import (
    FactorUpdater,
    LearningRateSchedule,
    MockFactorUpdater,
    RegularizedSGDUpdater,
    SGDUpdater,
    constant_lr,
    inverse_sqrt_lr,
)

__all__ = [
    "Ratings",
    "FactorVector",
    "UserUpdate",
    "ItemUpdate",
    "FactorInitializer",
    "RandomFactorInitializer",
    "PseudoRandomFactorInitializer",
    "FactorUpdater",
    "SGDUpdater",
    "RegularizedSGDUpdater",
    "MockFactorUpdater",
    "LearningRateSchedule",
    "constant_lr",
    "inverse_sqrt_lr",
    "UniformRatingGenerator",
    "ExponentialRatingGenerator",
    "DiscreteExponentialGenerator",
    "ThroughputLimiter",
]
