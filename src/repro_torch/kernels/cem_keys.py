"""Fused coarsen + bit-pack of CEM group keys: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces ``repro/kernels/cem_keys.py::cem_keys_pallas``. The kernel
(``csrc/cem_keys.cu``) is one thread per row with the cutpoint table in
shared memory; it is bound by memory — N*(4d + 1) bytes in, 16N bytes of
int64 key words out. Integer arithmetic only, so kernel and plain version
agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

KERNEL = build.KERNELS["cem_keys"]
# the u32 mask, which is also the invalid-key marker of both words
# (``repro_torch.core.keys``; not imported from there, as importing
# ``repro_torch.core`` imports this module)
U32 = 0xFFFFFFFF


def cem_keys_plain(X: torch.Tensor, cutpoints: torch.Tensor,
                   n_cuts: torch.Tensor, widths: torch.Tensor,
                   valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """X (N, d) f32; cutpoints (d, C) f32 +inf padded; n_cuts, widths (d,)
    int32; valid (N,) bool -> (hi, lo) int64 holding u32 key words. Bucket
    of covariate j = count of its real cutpoints <= x, packed MSB-first in
    column order; invalid rows get the 0xFFFFFFFF marker."""
    n, d = X.shape
    hi = torch.zeros((n,), dtype=torch.int64, device=X.device)
    lo = torch.zeros_like(hi)
    for j, (nc, w) in enumerate(zip(n_cuts.tolist(), widths.tolist())):
        if w == 0:
            continue
        b = (X[:, j:j + 1] >= cutpoints[j, :nc][None, :]).sum(
            dim=1, dtype=torch.int64)
        hi = ((hi << w) | (lo >> (32 - w))) & U32
        lo = ((lo << w) | b) & U32
    hi = torch.where(valid, hi, U32)
    lo = torch.where(valid, lo, U32)
    return hi, lo


def cem_keys(X: torch.Tensor, cutpoints: torch.Tensor, n_cuts: torch.Tensor,
             widths: torch.Tensor, valid: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`cem_keys_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if X.device.type == "cpu":
        return cem_keys_plain(X, cutpoints, n_cuts, widths, valid)
    dev = build.require_cuda("cem_keys", X, cutpoints, n_cuts, widths, valid)
    n, d = X.shape
    c = cutpoints.shape[1]
    build.check("cem_keys X", X, torch.float32, (n, d))
    build.check("cem_keys cutpoints", cutpoints, torch.float32, (d, c))
    build.check("cem_keys n_cuts", n_cuts, torch.int32, (d,))
    build.check("cem_keys widths", widths, torch.int32, (d,))
    build.check("cem_keys valid", valid, torch.bool, (n,))
    hi = torch.empty((n,), dtype=torch.int64, device=dev)
    lo = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        KERNEL.launch(dev, X.data_ptr(), cutpoints.data_ptr(),
                      n_cuts.data_ptr(), widths.data_ptr(), valid.data_ptr(),
                      hi.data_ptr(), lo.data_ptr(), n, d, c)
    return hi, lo
