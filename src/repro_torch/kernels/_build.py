"""Build the CUDA sources with ``nvcc`` at first use, load them, and check
what the wrappers hand them.

Each source (a file under ``csrc/``, or one generated from a template
there) is compiled for ``sm_90a`` into its own shared library with a plain
C interface and loaded with ``ctypes``. Libraries are cached under
``kernels/_build/`` (listed in ``.gitignore``), named by a hash of the
source text and the flags, so an edited source is rebuilt and an unchanged
one is not. ``build_all`` starts one ``nvcc`` per missing library, all at
once, and waits for every one of them.

The wrappers validate their inputs with ``check_inputs`` / ``check_rows``
before passing raw pointers, launch on PyTorch's current stream
(``stream_of``), and raise through ``check_launch`` when the C entry
returns a non-zero ``cudaGetLastError()``.

Nothing here runs on import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[Path, ctypes.CDLL] = {}


def read_source(filename: str) -> str:
    return (CSRC / filename).read_text()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, text: str) -> Path:
    digest = hashlib.sha256(("\0".join(NVCC_FLAGS) + "\0" + text).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(sources: Iterable[Tuple[str, str]]) -> float:
    """Compile every ``(name, source text)`` whose library is missing, one
    ``nvcc`` process each, all started together. Returns the seconds spent;
    raises ``RuntimeError`` with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs: List[Tuple[Path, Path, subprocess.Popen]] = []
    pending = set()
    for name, text in sources:
        lib = library_path(name, text)
        if lib.exists() or lib in pending:
            continue
        pending.add(lib)
        cu = lib.with_suffix(".cu")
        cu.write_text(text)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((lib, Path(tmp), proc))
    errors = []
    for lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib)  # atomic: a reader never sees half a library
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{lib.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, text: str, functions: Dict[str, tuple]) -> ctypes.CDLL:
    """The library built from ``text`` (building it if needed), with
    ``argtypes`` set for each entry in ``functions`` and ``restype`` int."""
    lib_path = library_path(name, text)
    lib = _LIBS.get(lib_path)
    if lib is None:
        build_all([(name, text)])
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[lib_path] = lib
    return lib


def check_inputs(kernel: str, dtypes=(torch.float32,), **tensors) -> None:
    """Raise unless every tensor is a contiguous tensor of one of ``dtypes``
    (float32 by default) on the current CUDA device (the kernels launch there)."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not a CUDA device")
        if t.dtype not in dtypes:
            raise TypeError(f"{kernel}: {name} is {t.dtype}; the kernel takes "
                            + " or ".join(str(d).replace("torch.", "") for d in dtypes))
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.device.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"{kernel}: {name} is on {t.device}, not the current "
                             f"device cuda:{torch.cuda.current_device()}")


def check_rows(kernel: str, name: str, n: int, limit: int = 64) -> None:
    if not 1 <= n <= limit:
        raise ValueError(f"{kernel}: {name}={n} outside 1..{limit}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(kernel: str, code: int) -> None:
    """Raise if the C entry reported a non-zero ``cudaGetLastError()``."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")
