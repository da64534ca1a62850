"""The request-facing serving layer (counterpart of
``large_scale_recommendation_tpu.serving``): the micro-batching engine,
the int8 two-stage retriever, admission control and delta catalog swaps.
See ``serving.engine.ServingEngine``."""

from large_scale_recommendation_tpu_torch.serving.admission import (
    AdmissionConfig,
    AdmissionController,
    AdmissionRejectedError,
)
from large_scale_recommendation_tpu_torch.serving.engine import (
    RecResult,
    ServingEngine,
)
from large_scale_recommendation_tpu_torch.serving.retrieval import (
    QuantizedCatalog,
    RetrievalConfig,
    TwoStageRetriever,
    build_quantized_catalog,
    quantize_rows,
    recall_at_k,
)

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionRejectedError",
    "QuantizedCatalog",
    "RecResult",
    "RetrievalConfig",
    "ServingEngine",
    "TwoStageRetriever",
    "build_quantized_catalog",
    "quantize_rows",
    "recall_at_k",
]
