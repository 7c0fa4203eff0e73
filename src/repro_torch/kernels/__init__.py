# Hand-written CUDA kernels for Hopper (csrc/), their plain PyTorch versions,
# and the flat-vector wrappers (ops.py) the compressors call.
