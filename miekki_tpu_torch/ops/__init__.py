"""Device compute path: order keys, hashing, sketching, intersection.

Kernel wrappers (ops.cuda_hash K1, ops.cuda_sketch K2, ops.cuda_intersect
K3, ops.cuda_intersect32 K4) build their CUDA sources at first launch,
never at import.
"""
