"""ZaliQL's online causal engine in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (``sm_90a``).

This package is the PyTorch counterpart of :mod:`repro` (the JAX/Pallas
reference). Module names mirror ``repro`` so that each function's
reference is easy to find; the tests hold every ported function against
its ``repro`` twin on the same numpy inputs. It imports ``torch`` and
numpy only — never ``jax`` and nothing under ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`). On a CUDA tensor every kernel
wrapper launches its hand-written kernel or raises; the plain PyTorch
versions beside the kernels run only for CPU tensors.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
