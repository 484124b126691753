"""Plain float32 PyTorch references of the benchmarked model families.

They import nothing of the program under test (``tennis_torch``), nor JAX:
each family module builds its own parameter list from the configuration
and computes from the weights and inputs the benchmark hands it.
"""
