"""PyTorch/CUDA port of tennis_tpu, beside the JAX package (the reference).

The port imports torch and never JAX or tennis_tpu. Its entry points run on
the GPU unless the caller asks for the CPU; every TPU kernel on a ported path
is a hand-written CUDA kernel under ``csrc/``, built at first use.
"""
