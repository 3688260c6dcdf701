"""Build and load the port's hand-written CUDA kernels.

Each source under ``octa_tpu_torch/csrc/`` has a plain C interface. At first
use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/kernels/`` at the root of the checkout, named by a
hash of the source and flags so that an edited source is rebuilt, and loaded
with ``ctypes``. Nothing is compiled or loaded when a module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@functools.cache
def multiprocessors(dev) -> int:
    """Streaming multiprocessors of the CUDA device ``dev``: the launch rules
    size their grids by it."""
    import torch

    return torch.cuda.get_device_properties(dev).multi_processor_count


def on_device(dev):
    """The context of a launch on the CUDA device ``dev``. The C launchers
    launch on the calling thread's current device: a tensor on another card
    is launched under ``torch.cuda.device(dev)``, and one on the current
    card (every call on a one-card host) under no guard, which saves the
    guard's host time."""
    import torch

    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_handle(dev) -> int:
    """The handle of PyTorch's current stream on the CUDA device ``dev``
    (without the ``Stream`` object that ``torch.cuda.current_stream``
    makes)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(dev.index)


_SCRATCH: dict = {}  # (device, stream) -> {name: tensor}


def scratch(dev, stream: int, **sizes) -> list:
    """The kernels' scratch on one stream, cached and grown on demand:
    ``name=(numel, dtype)`` -> tensors in that order, their contents left
    by the last launch. Launches on one stream run one after another, so
    every call on it may share them."""
    import torch

    bufs = _SCRATCH.setdefault((dev, stream), {})
    out = []
    for name, (numel, dtype) in sizes.items():
        t = bufs.get(name)
        if t is None or t.numel() < numel:
            t = bufs[name] = torch.empty(numel, dtype=dtype, device=dev)
        out.append(t)
    return out


def counters(dev, stream: int, numel: int):
    """``numel`` int32 counters on one stream, cached as :func:`scratch`
    is: zero when made, and every kernel that takes them leaves them
    zero."""
    import torch

    bufs = _SCRATCH.setdefault((dev, stream), {})
    t = bufs.get("counters")
    if t is None or t.numel() < numel:
        t = bufs["counters"] = torch.zeros(numel, dtype=torch.int32, device=dev)
    return t


def drop_scratch(dev, stream: int) -> None:
    """Forget the scratch and counters of one stream (after a failed
    launch, which may leave a counter set)."""
    _SCRATCH.pop((dev, stream), None)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


class CudaKernel:
    """One ``csrc`` source, its built library and its launch count.

    ``launches`` is a plain integer that the wrapper adds one to for every
    launch of the kernel and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        src = (CSRC_DIR / self.source).read_bytes()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{Path(self.source).stem}_{digest[:12]}.so"

    def build(self) -> Path:
        """Compile the source if its library is not built yet; return it."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source} ({proc.returncode}):\n"
                f"{self.build_log}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        return out

    def function(self):
        """The kernel's C launcher, built and loaded on first call."""
        if self._fn is None:
            lib = ctypes.CDLL(str(self.build()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
