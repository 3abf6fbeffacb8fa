"""Device compute path: order keys, hashing, sketching, intersection.

Kernel wrappers (ops.cuda_hash, ops.cuda_intersect) build their CUDA
sources at first launch, never at import.
"""
