"""sedef_tpu — segmental-duplication detection engine.

Re-implementation of the capabilities of vpc-ccg/sedef (ECCB 2018) in
JAX: batched device kernels for the gap DPs (a CUDA kernel on NVIDIA GPUs)
and a C++ host runtime for the scalar cores.
"""
