"""Building, loading and dispatching the hand-written CUDA kernels.

Each kernel is a ``csrc/<name>.cu`` file with plain C entry points (helpers
shared between files sit in ``csrc/*.cuh``).  It is compiled with ``nvcc``
for ``sm_90a`` into a shared library under the checkout's ``build/kernels/``
at first use (the file name carries a hash of the source and the headers, so
an edited source is rebuilt) and bound with ``ctypes``.
Nothing is compiled or loaded when a module is imported.

Dispatch rule, shared by every wrapper: a tensor on the CPU takes the
kernel's plain PyTorch version; a CUDA tensor launches the kernel, and a
failed build or launch raises.  ``plain_versions()`` is the one exception:
inside it the wrappers run their plain versions on any device, which is how
the kernels are held against those versions on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

__all__ = ["build", "function", "plain_versions", "in_plain_versions",
           "use_kernel",
           "check_float32", "KERNEL_SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("thomas", "fused_channel", "fused_channel_vjp",
                  "fused_channel_wide", "fused_grayscale",
                  "fused_grayscale_vjp", "fused_grayscale_wide")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_functions: dict = {}
_plain = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ on the machine with the card")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest = digest.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, Path]:
    """Compile the named kernels that are not built yet, one ``nvcc`` process
    for each, all started together.  Raises with the compiler's output if
    any build fails.  Returns {name: shared library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failures = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel ``name`` (built and loaded at
    first use), typed with ``argtypes`` and returning the CUDA error code."""
    with _lock:
        fn = _functions.get((name, symbol))
        if fn is None:
            fn = getattr(ctypes.CDLL(str(build((name,))[name])), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[(name, symbol)] = fn
        return fn


@contextmanager
def plain_versions():
    """Run every wrapper's plain PyTorch version, whatever the device: the
    reference the kernels are held against on the card.  The serving path
    never enters it."""
    prev = getattr(_plain, "on", False)
    _plain.on = True
    try:
        yield
    finally:
        _plain.on = prev


def in_plain_versions() -> bool:
    """Whether this thread is inside ``plain_versions()``."""
    return getattr(_plain, "on", False)


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor).  False: run the plain version
    (CPU tensor, or inside ``plain_versions``).  Any other device raises."""
    if in_plain_versions() or t.device.type == "cpu":
        return False
    if t.is_cuda:
        return True
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check_float32(name: str, device: torch.device, **tensors):
    """Raise unless every tensor is float32, contiguous and on ``device``."""
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
