"""PyTorch/CUDA port of the EVPLP renderer.

Mirrors the module layout of the JAX package (`core/`, `scene/`, `accel/`,
`trace/`, `integrators/`, `parallel/`, `runtime/`, `utils/`): every module
there has a counterpart here.  The three BVH traversals (`csrc/traverse.cu`,
`packet7.cu`, `packet.cu`) and the VSL sample loop (`csrc/vsl_sample.cu`)
run as hand-written CUDA kernels on CUDA tensors and as plain PyTorch on
CPU tensors.
Every entry point takes an explicit `device`, defaulting to "cuda".
"""
