"""Hand-written Hopper kernels (CUDA C++ in `../csrc`) and their wrappers.

Importing this package builds nothing: a kernel is compiled on its first
launch (or by `_build.build()`).
"""
