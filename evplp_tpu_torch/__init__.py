"""PyTorch/CUDA port of the EVPLP renderer.

Mirrors the module layout of the JAX package (`core/`, `scene/`, `accel/`,
`trace/`, `integrators/`, `runtime/`, `utils/`) so each module has a
counterpart there.  The BVH traversal (`csrc/traverse.cu`) and the VSL
sample loop (`csrc/vsl_sample.cu`) run as hand-written CUDA kernels on CUDA
tensors and as plain PyTorch on CPU tensors.
Every entry point takes an explicit `device`, defaulting to "cuda".
"""
