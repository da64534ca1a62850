"""Observability (counterpart of ``large_scale_recommendation_tpu.obs``):
only the SLO tracking that serving reads is ported so far."""
