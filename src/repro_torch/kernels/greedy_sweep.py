"""The greedy sweep of matching without replacement: the CUDA kernel's
wrapper and its plain version.

Replaces the ``lax.scan`` of ``repro/core/matching.py::greedy_nnmnr`` (not
a TPU kernel; a scan on the hot path becomes a kernel in the port). Over
candidate edges (d, control, treated) already in their global sort order,
an edge is taken iff ``d < BIG``, its control is unused and its treated
unit holds fewer than k controls; control and treated indices are clipped
to ``[0, n_rows)`` first, as the scan clips them. The sweep is sequential
by nature (each verdict depends on every earlier one; the paper's
Prop. 1), and the plain version is a Python loop. The kernels
(``csrc/greedy_sweep.cu``) drop the edges that are not below BIG, which
never change the state, keeping the order of the rest (a parallel
compaction); one thread of one block then walks what is left, in order,
with the state in shared memory, while the block's other warps stage the
next chunk of edges. Integer logic:
kernel and plain version agree bit for bit. The kernel takes n_rows below
2^31.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_I64 = ctypes.c_longlong

KERNEL = build.KERNELS["greedy_sweep"]
BIG = 3.4e38


def greedy_sweep_plain(d: torch.Tensor, c: torch.Tensor, t: torch.Tensor,
                       n_rows: int, k: int) -> torch.Tensor:
    """d (E,) f32, c and t (E,) int64 in sweep order -> taken (E,) bool."""
    big = torch.tensor(BIG, dtype=torch.float32)
    below = (d.cpu() < big).tolist()
    cs = torch.clamp(c, 0, n_rows - 1).tolist()
    ts = torch.clamp(t, 0, n_rows - 1).tolist()
    used_c = bytearray(n_rows)
    cnt_t = [0] * n_rows
    taken = [False] * len(cs)
    for e, (ok, ci, ti) in enumerate(zip(below, cs, ts)):
        if ok and not used_c[ci] and cnt_t[ti] < k:
            used_c[ci] = 1
            cnt_t[ti] += 1
            taken[e] = True
    return torch.tensor(taken, dtype=torch.bool, device=d.device)


def greedy_sweep(d: torch.Tensor, c: torch.Tensor, t: torch.Tensor,
                 n_rows: int, k: int) -> torch.Tensor:
    """Same contract as :func:`greedy_sweep_plain`. CPU tensors take the
    plain version; CUDA tensors launch the kernel (or raise)."""
    if d.device.type == "cpu":
        return greedy_sweep_plain(d, c, t, n_rows, k)
    dev = build.require_cuda("greedy_sweep", d, c, t)
    e = d.shape[0]
    build.check("greedy_sweep d", d, torch.float32, (e,))
    build.check("greedy_sweep c", c, torch.int64, (e,))
    build.check("greedy_sweep t", t, torch.int64, (e,))
    if n_rows < 1:
        raise ValueError(f"greedy_sweep: n_rows={n_rows}")
    taken = torch.zeros((e,), dtype=torch.bool, device=dev)
    if e:
        words = KERNEL.function("greedy_sweep_scratch_words", [_I64, _I64],
                                _I64)(e, n_rows)
        scratch = torch.empty((words,), dtype=torch.int64, device=dev)
        KERNEL.launch(dev, d.data_ptr(), c.data_ptr(), t.data_ptr(), e,
                      n_rows, k, scratch.data_ptr(), words,
                      taken.data_ptr())
    return taken

