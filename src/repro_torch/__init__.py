"""CARMEN on PyTorch and CUDA: a port of ``repro`` to an NVIDIA H100.

Mirrors ``repro`` module for module. Imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.
"""
