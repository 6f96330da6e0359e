"""PyTorch/CUDA port of the USEC elastic-computing system.

A second package beside the JAX reference :mod:`repro`, with the same
layout: ``core`` (planning, pure NumPy), ``runtime`` (simulation, the
executor and the live elastic runner), ``kernels`` (hand-written CUDA
kernels for NVIDIA Hopper, with plain PyTorch versions) and ``api`` (the
``ElasticEngine`` front door). Device entry points run on CUDA unless the
caller passes ``device="cpu"``. Nothing here imports JAX or :mod:`repro`.
"""

__version__ = "0.1.0"
