"""PyTorch/CUDA port of the EWQ reproduction: entropy analysis, plan
compilation, the dense model family and the continuous-batching serving
engine, with hand-written Hopper kernels under ``csrc/``.

The JAX package ``repro`` stays the reference; this package imports
nothing of it and nothing of JAX.
"""
