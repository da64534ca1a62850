"""large_scale_recommendation_tpu_torch — the PyTorch/CUDA port of
``large_scale_recommendation_tpu`` for NVIDIA Hopper (H100).

The module paths mirror the JAX package, so each counterpart sits where a
reader of the JAX package expects it. The port imports ``torch`` and never
``jax``, and nothing of the JAX package: the host-side numpy code it needs
(ratings batches, generators, blocking) is copied here.

This slice carries the DSGD training path end to end:

    data.movielens.synthetic_like      planted low-rank ratings (numpy)
    data.blocking.block_problem        k×k Gemulla strata (numpy, bit-equal
                                       to the JAX package's layout)
    models.dsgd.DSGD.fit               factor init + stratum sweeps
    ops.cuda_sgd.dsgd_train_cuda       hand-written sm_90a kernels
                                       (csrc/dsgd_sweep.cu) on a CUDA device
    ops.sgd.dsgd_train                 the plain PyTorch route (CPU tensors)
    models.mf.MFModel.rmse             holdout RMSE

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
