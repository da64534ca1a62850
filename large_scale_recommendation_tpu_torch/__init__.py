"""large_scale_recommendation_tpu_torch — the PyTorch/CUDA port of
``large_scale_recommendation_tpu`` for NVIDIA Hopper (H100).

The module paths mirror the JAX package, so each counterpart sits where a
reader of the JAX package expects it. The port imports ``torch`` and never
``jax``, and nothing of the JAX package: the host-side numpy code it needs
(ratings batches, generators, blocking) is copied here.

The port carries the DSGD training path end to end, through a host and
an on-device data pipeline, with f32 or bf16 factor tables, and what a
trained model is used for:

    data.movielens.synthetic_like      planted low-rank ratings (numpy)
    data.movielens.load_ratings_file   MovieLens files (native parser)
    data.blocking.block_problem        k×k Gemulla strata (csrc/fastblock
                                       .cpp via data.native, bit-equal to
                                       the JAX package's layout)
    models.dsgd.DSGD.fit               factor init + stratum sweeps
    data.device_blocking               generation + blocking in torch on
                                       the solver's device
    models.dsgd.DSGD.fit_device        the same sweeps from that layout
    ops.cuda_sgd.dsgd_train_cuda       hand-written sm_90a kernels
                                       (csrc/dsgd_sweep.cu) on a CUDA device
    ops.sgd.dsgd_train                 the plain PyTorch route (CPU tensors)
    models.mf.MFModel.rmse             holdout RMSE
    models.mf.MFModel.recommend        top-K items per user (utils.metrics)
    models.mf.MFModel.ranking_quality  HR@K / NDCG@K of held-out pairs
    utils.checkpoint                   snapshots and resume (the JAX
                                       package's file format)
    models.als.ALS / models.online     ALS and online MF (torch ops)
    serving.ServingEngine              micro-batched top-K over a
                                       versioned catalog, the int8
                                       two-stage retriever, admission
                                       control, delta swaps (torch ops)

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
