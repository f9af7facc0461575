"""Kernel library of the port: integer helpers, the plain oracle, and the
CUDA layer kernels with their build (``build``) and sources (``csrc``)."""
