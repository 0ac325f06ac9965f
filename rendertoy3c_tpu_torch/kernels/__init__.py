"""Hand-written CUDA kernels of the port (sources in csrc/, built by build.py).

Importing this package compiles nothing; `build.library()` does, on the
first CUDA launch.
"""
