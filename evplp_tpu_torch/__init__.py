"""PyTorch/CUDA port of the EVPLP renderer.

Mirrors the module layout of the JAX package (`core/`, `scene/`, `accel/`,
`trace/`, `integrators/`, `runtime/`, `utils/`) so each module has a
counterpart there.  The BVH traversal runs as a hand-written CUDA kernel
(`csrc/traverse.cu`) on CUDA tensors and as plain PyTorch on CPU tensors.
Every entry point takes an explicit `device`, defaulting to "cuda".
"""
