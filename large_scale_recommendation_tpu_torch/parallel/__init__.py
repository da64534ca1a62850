"""Multi-device machinery (counterpart of
``large_scale_recommendation_tpu.parallel``): so far only the single-card
part of top-K serving (``parallel.serving``)."""
