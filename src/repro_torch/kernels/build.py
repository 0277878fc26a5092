"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
through ``ctypes`` — no PyTorch headers, so a build takes seconds. Builds
happen at first use (or all at once, in parallel, through
:func:`build_all`) into ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source and the shared headers, so an
edited source never loads a stale library.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :meth:`Kernel.launch` raises
when that is non-zero and counts the launches that went through — the
plain integer :attr:`Kernel.launches` is how a run shows that a path
really reached the kernel. A kernel whose last block takes a combine by
an integer ticket (``csrc/chunk_tree.cuh``) is also handed a 4-byte
counter, one per device and stream (:func:`ticket`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_BYTES = ctypes.c_char_p   # a host array, passed without a copy


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


class Kernel:
    """One CUDA source, its C entry point and its launch counter."""

    def __init__(self, name: str, source: str, entry: str,
                 argtypes: Sequence, ticketed: bool = False):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        # the entry takes the ticket counter just before the stream
        self.ticketed = ticketed
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    @property
    def library(self) -> Path:
        """The built library, named by a hash of the source and of every
        header in ``csrc/`` (which it may include)."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.so"

    def _load(self):
        with self._lock:
            if self._fn is None:
                if not self.library.exists():
                    build_all([self])
                lib = ctypes.CDLL(str(self.library))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.repro_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a launch error.
        Switches the current device only when ``device`` is another card
        (the engine launches hundreds of times per ingest on one card).
        The current device and stream come from PyTorch's C hooks as plain
        ints (:func:`_cuda_hooks`), not as ``torch.cuda`` objects."""
        fn = self._fn or self._load()
        get_device, raw_stream = _HOOKS or _cuda_hooks()
        current = get_device()
        if device.index is not None and device.index != current:
            with torch.cuda.device(device):
                return self.launch(device, *args)
        stream = raw_stream(current)
        code = (fn(*args, ticket(current, stream), stream) if self.ticketed
                else fn(*args, stream))
        if code != 0:
            msg = self._lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(
                f"CUDA kernel {self.name!r} failed to launch: error {code} "
                f"({msg})")
        self.launches += 1

    def function(self, entry: str, argtypes: Sequence, restype=ctypes.c_int):
        """Another C function of this kernel's library (a sizing helper, or
        a yardstick kernel); calling it counts no launch."""
        if self._fn is None:
            self._load()
        fn = getattr(self._lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn


_HOOKS: Tuple = ()


def _cuda_hooks() -> Tuple:
    """PyTorch's current-device query and current raw stream handle of a
    device (what Triton's launcher reads), looked up at the first launch:
    a CPU build of PyTorch has neither."""
    global _HOOKS
    _HOOKS = (torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream)
    return _HOOKS


# (device index, stream handle) -> (counter, its address)
_TICKETS: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}
_TICKETS_LOCK = threading.Lock()


def ticket(index: int, stream: int) -> int:
    """The address of the 4-byte ticket counter of device ``index`` and
    ``stream``, zeroed once, at first use, on that stream, and kept (never
    freed) while this module is loaded. A ticketed kernel's last block puts
    it back to 0, and two launches on one stream run one after the other,
    so they never hold it at once; launches on two streams hold two
    counters."""
    key = (index, stream)
    hit = _TICKETS.get(key)
    if hit is None:
        with _TICKETS_LOCK:
            hit = _TICKETS.get(key)
            if hit is None:
                counter = torch.zeros((1,), dtype=torch.int32,
                                      device=torch.device("cuda", index))
                hit = _TICKETS[key] = (counter, counter.data_ptr())
    return hit[1]


def build_all(kernels: Optional[Sequence[Kernel]] = None) -> List[str]:
    """Compile every kernel whose library is missing — one ``nvcc`` per
    source, all started together. Raises with the compiler's output if any
    build fails. Returns the names of the kernels built now (the others
    were cached)."""
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in kernels:
        if k.library.exists():
            continue
        tmp = k.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs[k.name] = (k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failures = []
    for name, (k, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} ({k.source.name}) ---\n"
                            f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, k.library)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return list(procs)


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


KERNELS: Dict[str, Kernel] = {
    "cem_keys": Kernel(
        "cem_keys", "cem_keys.cu", "cem_keys_launch", [_BYTES, _BYTES, _P]),
    "segment_sums": Kernel(
        "segment_sums", "segment_sums.cu", "segment_sums_launch",
        [_P, _P, _P, _P, _P, _I64, _I32, _I64, _P]),
    "scatter_merge": Kernel(
        "scatter_merge", "scatter_merge.cu", "scatter_merge_launch",
        [_P, _P, _P, _P, _I64, _I32, _I64, _P]),
    "scatter_merge_parts": Kernel(
        "scatter_merge_parts", "scatter_merge_parts.cu",
        "scatter_merge_parts_launch",
        [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I64, _P]),
    "chunk_sums": Kernel(
        "chunk_sums", "chunk_sums.cu", "chunk_sums_launch",
        [_P, _P, _I64, _I64, _I64, _P, _P], ticketed=True),
    "logistic_newton_terms": Kernel(
        "logistic_newton_terms", "logistic_grad.cu",
        "logistic_newton_terms_launch",
        [_P, _P, _P, _P, _P, _I64, _I32, _I64, _P, _P], ticketed=True),
    "knn_topk": Kernel(
        "knn_topk", "knn_topk.cu", "knn_topk_launch",
        [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _I32,
         _I64, _P]),
    "greedy_sweep": Kernel(
        "greedy_sweep", "greedy_sweep.cu", "greedy_sweep_launch",
        [_P, _P, _P, _I64, _I64, _I32, _P, _I64, _P, _P]),
}


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Shared device check of the kernel wrappers: every tensor on one CUDA
    device. Returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Dtype / shape / contiguity check of one kernel argument."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")

