"""Fused coarsen + bit-pack of CEM group keys: the CUDA kernel's wrappers
and its plain PyTorch version.

Replaces ``repro/kernels/cem_keys.py::cem_keys_pallas``. The kernel
(``csrc/cem_keys.cu``) reads a batch's columns where they lie, each in its
own dtype and element stride, converts each element to f32 as
``Tensor.to(torch.float32)`` does, and counts the cutpoints at or below
it; it is bound by memory — each row's column elements and validity
element in, 16 bytes of int64 key words out. Exact conversions, compares
and integer shifts only, so kernel and plain version agree bit for bit.

Two entry forms share the kernel: :func:`cem_keys_cols` (the columns of
a batch, what the paths call) and :func:`cem_keys` (an (N, d) f32 matrix,
the TPU kernel's form; its columns go in as strided views). Both forms
refuse, on every device, what the kernel does not take.
"""
from __future__ import annotations

import struct
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build

KERNEL = build.KERNELS["cem_keys"]
# the u32 mask, which is also the invalid-key marker of both words
# (``repro_torch.core.keys``; not imported from there, as importing
# ``repro_torch.core`` imports this module)
U32 = 0xFFFFFFFF
# columns the launch's parameter struct holds (csrc/cem_keys.cu
# REPRO_CEM_MAX_COLS) and the widest key (``repro_torch.core.keys._MAX_BITS``)
MAX_COLUMNS = 64
MAX_KEY_BITS = 63
# dtype codes of csrc/cem_keys.cu: every dtype the kernel reads natively
DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.bfloat16: 3, torch.int64: 4, torch.int32: 5, torch.int16: 6,
          torch.int8: 7, torch.uint8: 8, torch.bool: 9}
# int64 words of the launch before the columns' (pointer, element stride,
# dtype code) triples: hi, lo, cut, valid pointer, stride and dtype code,
# n, d, C
_HEAD = 9
_CALLS: Dict[int, struct.Struct] = {}


def _ints(x) -> Tuple[int, ...]:
    """Cutpoint counts or widths as a tuple of host ints."""
    return x if type(x) is tuple else tuple(int(v) for v in x)


def fields(n_cuts: Sequence[int], widths: Sequence[int]) -> bytes:
    """The launch's per-codec part: each column's (real cutpoint count, bit
    width) as int32 pairs. Refuses (ValueError) what the kernel does not
    take: more than MAX_COLUMNS columns, a key over MAX_KEY_BITS bits, a
    field over 32. Built once per cutpoint table
    (:class:`repro_torch.kernels.ops.CutpointTable`)."""
    d = len(widths)
    if d > MAX_COLUMNS:
        raise ValueError(f"cem_keys: {d} columns; the kernel takes at most "
                         f"{MAX_COLUMNS}")
    if len(n_cuts) != d:
        raise ValueError(f"cem_keys: {len(n_cuts)} cutpoint counts, {d} "
                         f"widths")
    if sum(widths) > MAX_KEY_BITS or (d and not (
            0 <= min(widths) <= max(widths) <= 32 and min(n_cuts) >= 0)):
        raise ValueError(f"cem_keys: field widths {tuple(widths)}: a key "
                         f"holds at most {MAX_KEY_BITS} bits, a field 32")
    pairs = [v for p in zip(n_cuts, widths) for v in p]
    return struct.pack(f"={len(pairs)}i", *pairs)


def cem_keys_plain(X: torch.Tensor, cutpoints: torch.Tensor, n_cuts,
                   widths, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X (N, d) f32; cutpoints (d, C) f32 +inf padded; n_cuts, widths (d,)
    ints; valid (N,) bool -> (hi, lo) int64
    holding u32 key words. Bucket of covariate j = count of its real
    cutpoints <= x, packed MSB-first in column order; invalid rows get the
    0xFFFFFFFF marker."""
    n, d = X.shape
    hi = torch.zeros((n,), dtype=torch.int64, device=X.device)
    lo = torch.zeros_like(hi)
    for j, (nc, w) in enumerate(zip(_ints(n_cuts), _ints(widths))):
        if w == 0:
            continue
        b = (X[:, j:j + 1] >= cutpoints[j, :nc][None, :]).sum(
            dim=1, dtype=torch.int64)
        hi = ((hi << w) | (lo >> (32 - w))) & U32
        lo = ((lo << w) | b) & U32
    hi = torch.where(valid, hi, U32)
    lo = torch.where(valid, lo, U32)
    return hi, lo


def _launch_words(cols: Sequence[torch.Tensor], valid: torch.Tensor,
                  cutpoints: torch.Tensor, n_cuts: Tuple[int, ...]) -> list:
    """The column route's per-call guards, the same on every device: one
    cutpoint count a column, each column (N,) like ``valid`` and on its
    device, every dtype one the kernel reads, the cut table (d, C >= every
    count) f32, contiguous, on the same device. Returns the launch's words
    after its head: each column's (pointer, element stride, dtype code)."""
    d = len(cols)
    if len(n_cuts) != d:
        raise ValueError(f"cem_keys: {d} columns, {len(n_cuts)} cutpoint "
                         f"counts")
    if valid.dtype not in DTYPES:
        raise TypeError(f"cem_keys: no kernel read for a {valid.dtype} "
                        f"validity mask")
    if valid.ndim != 1:
        raise ValueError(f"cem_keys valid: expected (N,), got "
                         f"{tuple(valid.shape)}")
    n = valid.numel()
    where = valid.get_device()
    if cutpoints.get_device() != where or (
            where < 0 and cutpoints.device != valid.device):
        raise ValueError(f"cem_keys: cutpoints on {cutpoints.device}, valid "
                         f"on {valid.device}")
    if cutpoints.dtype != torch.float32:
        raise TypeError(f"cem_keys cutpoints: expected torch.float32, got "
                        f"{cutpoints.dtype}")
    if (cutpoints.ndim != 2 or cutpoints.shape[0] != d
            or (d and cutpoints.shape[1] < max(n_cuts))
            or not cutpoints.is_contiguous()):
        raise ValueError(f"cem_keys cutpoints: expected a contiguous (d={d}, "
                         f"C >= {max(n_cuts, default=0)}) table, got "
                         f"{tuple(cutpoints.shape)}")
    words = []
    code_of = DTYPES.get
    for t in cols:
        code = code_of(t.dtype)
        if code is None:
            raise TypeError(f"cem_keys: no kernel read for a {t.dtype} column")
        if t.ndim != 1 or t.numel() != n or t.get_device() != where or (
                where < 0 and t.device != valid.device):
            raise ValueError(f"cem_keys: a column {tuple(t.shape)} on "
                             f"{t.device}; valid ({n},) on {valid.device}")
        words += (t.data_ptr(), 1 if t.is_contiguous() else t.stride(0),
                  code)
    return words


def cem_keys_cols(cols: Sequence[torch.Tensor], valid: torch.Tensor,
                  cutpoints: torch.Tensor, n_cuts, widths,
                  packed: bytes = b"") -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarsen + pack d columns (each (N,), of any dtype in DTYPES and any
    stride) -> (hi, lo) int64: the keys of :func:`cem_keys_plain` over
    ``torch.stack([c.to(torch.float32) for c in cols], 1)`` and
    ``valid.to(torch.bool)``. On the CPU that is how they are computed; on
    CUDA one launch of the kernel reads the columns where they lie (no
    conversion, stack or copy). ``packed`` is :func:`fields` of
    (n_cuts, widths) when the caller keeps it (a cutpoint table does); it
    is built, and the per-codec part checked, when it is not given."""
    n_cuts, widths = _ints(n_cuts), _ints(widths)
    packed = packed or fields(n_cuts, widths)
    words = _launch_words(cols, valid, cutpoints, n_cuts)
    n = valid.numel()
    if not valid.is_cuda:
        if valid.device.type != "cpu":
            raise ValueError(f"cem_keys: no kernel for device {valid.device}")
        X = (torch.stack([c.to(torch.float32) for c in cols], 1) if cols
             else torch.zeros((n, 0), dtype=torch.float32))
        return cem_keys_plain(X, cutpoints, n_cuts, widths,
                              valid.to(torch.bool))
    dev = valid.device
    hi = torch.empty(n, dtype=torch.int64, device=dev)
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        d = len(cols)
        call = _CALLS.get(d)
        if call is None:
            call = _CALLS[d] = struct.Struct(f"={_HEAD + 3 * d}q")
        KERNEL.launch(dev, call.pack(
            hi.data_ptr(), lo.data_ptr(), cutpoints.data_ptr(),
            valid.data_ptr(), 1 if valid.is_contiguous() else valid.stride(0),
            DTYPES[valid.dtype], n, d, cutpoints.shape[1], *words), packed)
    return hi, lo


def cem_keys(X: torch.Tensor, cutpoints: torch.Tensor, n_cuts, widths,
             valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matrix form, same contract as :func:`cem_keys_plain` (X (N, d)
    f32 of any strides, valid (N,) bool). CPU tensors take the plain
    version; CUDA tensors launch the kernel on X's columns (strided views)
    or raise."""
    if X.device.type == "cpu":
        return cem_keys_plain(X, cutpoints, n_cuts, widths, valid)
    if X.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"cem_keys: expected X float32 and valid bool, got "
                        f"{X.dtype} and {valid.dtype}")
    if X.dim() != 2:
        raise ValueError(f"cem_keys X: expected (N, d), got {tuple(X.shape)}")
    if valid.shape != X.shape[:1]:
        raise ValueError(f"cem_keys valid: expected ({X.shape[0]},), got "
                         f"{tuple(valid.shape)}")
    return cem_keys_cols(X.unbind(1), valid, cutpoints, n_cuts, widths)
