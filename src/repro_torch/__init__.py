"""repro_torch — the PyTorch/CUDA port of the DGRO reproduction.

A second package beside ``repro`` (the JAX reference, left as it is).  It
imports torch, numpy and scipy, never jax and nothing of ``repro``; its
layout mirrors ``repro`` module for module, and its tests hold it to the
reference on the same numpy inputs.

This slice carries the paper's main path: latency matrices
(``core.topology``), rings (``core.construction``), candidate overlays
scored by APSP diameter (``core.diameter`` -> ``core.batcheval`` -> the
CUDA min-plus kernels in ``kernels.minplus``), ring selection by the
clustering ratio (``core.selection``), and the ``Overlay`` with its
builders (``overlay.build("dgro", w)``).

Device rule (``repro_torch.device``): tensors go to CUDA unless the caller
asks for the CPU; with no CUDA device an entry point raises.  Host-side
objects (latency matrices, ``Overlay`` fields) stay numpy.
"""
from .device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
