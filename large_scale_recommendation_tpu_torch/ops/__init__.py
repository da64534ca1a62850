"""Numeric kernels: the plain PyTorch SGD route (``sgd``) and the
hand-written CUDA stratum sweep (``cuda_sgd``)."""
