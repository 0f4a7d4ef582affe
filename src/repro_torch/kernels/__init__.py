"""Hopper kernels for the ABFT hot spots (CUDA C++ under csrc/, built with
nvcc at first use and bound with ctypes):

- abft_matmul: GEMM with the output-summation encode in its epilogue.
- checksum_reduce: single-pass S_o encode of an existing output.

Each wrapper runs its plain PyTorch version (ref.py) on a CPU tensor and
launches its kernel on a CUDA tensor.
"""
from . import abft_matmul, checksum_reduce, ops, ref

__all__ = ["abft_matmul", "checksum_reduce", "ops", "ref"]
