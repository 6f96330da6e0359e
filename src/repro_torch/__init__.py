"""PyTorch/CUDA port of the USEC elastic-computing system.

A second package beside the JAX reference :mod:`repro`, with the same
layout: ``core`` (planning, pure NumPy), ``runtime`` (simulation, the
executor and the live elastic runner), ``kernels`` (hand-written CUDA
kernels for NVIDIA Hopper, with plain PyTorch versions), ``api`` (the
``ElasticEngine`` front door), ``configs``, ``models``, ``optim``,
``data`` and ``launch`` (the model stack's serving path and its one-card
trainer). Device entry points run on CUDA unless the
caller passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
Nothing here imports JAX or :mod:`repro`.
"""

__version__ = "0.1.0"
