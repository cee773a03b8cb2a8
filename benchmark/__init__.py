"""The benchmark of the PyTorch and CUDA port ``witw_tpu_torch`` (see
``run.py``). It imports torch, numpy and the port, and never JAX or the
JAX package ``witw_tpu``."""
