"""Build the CUDA sources with ``nvcc`` at first use, load them, and check
what the wrappers hand them.

Each source (a file under ``csrc/``, or one generated from a template
there) is compiled for ``sm_90a`` into its own shared library with a plain
C interface and loaded with ``ctypes``. Libraries are cached under
``kernels/_build/`` (listed in ``.gitignore``), named by a hash of the
source text and the flags, so an edited source is rebuilt and an unchanged
one is not. ``build_all`` starts one ``nvcc`` per missing library, all at
once, and waits for every one of them. ``ptxas`` reports each kernel's
registers, shared memory and spills (``-Xptxas -v``); the compiler's output
is kept beside the library (``build_log``).

The aggregation kernels take the worker rows X as fp32, bf16 or fp16
(``X_TYPES``): ``x_source`` prepends the element type and ``csrc/xtype.cuh``
to a source, and each type is a library of its own. Their other inputs
come in fp32 (``as_f32`` casts a 16-bit one, as the reference's wrappers
do) and their outputs are fp32.

The wrappers validate their inputs with ``check_inputs`` / ``check_rows``
(any row count of at least one) before passing raw pointers, launch on
PyTorch's current stream (``stream_of``), and raise through
``check_launch`` when the C entry returns a non-zero
``cudaGetLastError()``. A ``FakeTensor`` input (``is_fake``) launches
nothing: the wrapper returns an empty output of the right shape before it
checks or builds anything (``kernels/cost.py`` records the call's cost).

Nothing here runs on import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake  # noqa: F401  (the wrappers read it here)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[Path, ctypes.CDLL] = {}

#: X's element types the aggregation kernels take: dtype -> (C type, suffix
#: of the library's name)
X_TYPES = {torch.float32: ("float", ""), torch.bfloat16: ("__nv_bfloat16", "_bf16"),
           torch.float16: ("__half", "_f16")}
X_DTYPES = tuple(X_TYPES)


def read_source(filename: str) -> str:
    return (CSRC / filename).read_text()


def x_source(name: str, text: str, dtype: torch.dtype = torch.float32) -> Tuple[str, str]:
    """``(library name, source)`` of an aggregation kernel built for X of
    ``dtype``: ``#define X_T`` and ``csrc/xtype.cuh`` before ``text``."""
    if dtype not in X_TYPES:
        raise TypeError(f"{name}: X is {dtype}; the kernel takes "
                        + " or ".join(str(d).replace("torch.", "") for d in X_DTYPES))
    ctype, suffix = X_TYPES[dtype]
    return name + suffix, f"#define X_T {ctype}\n" + read_source("xtype.cuh") + text


def as_f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A 16-bit floating tensor cast to fp32; any other (fp32, fp64, ints,
    ``None``) as it is, so ``check_inputs`` still refuses what it refuses."""
    if t is not None and t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


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
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)  # atomic: a reader never sees half a library
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{lib.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str, text: str) -> str:
    """The compiler's output (``ptxas`` resource lines included) from the
    build of ``text``; empty if the library was built elsewhere."""
    log = library_path(name, text).with_suffix(".log")
    return log.read_text() if log.exists() else ""


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


def check_inputs(kernel: str, dtypes: Optional[Mapping[str, Tuple[torch.dtype, ...]]] = None,
                 **tensors) -> None:
    """Raise unless every tensor is contiguous, on the current CUDA device (the
    kernels launch there) and of one of its dtypes: ``dtypes[name]`` for
    the tensors named there, float32 for the others."""
    for name, t in tensors.items():
        allowed = (dtypes or {}).get(name, (torch.float32,))
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not a CUDA device")
        if t.dtype not in allowed:
            raise TypeError(f"{kernel}: {name} is {t.dtype}; the kernel takes "
                            + " or ".join(str(d).replace("torch.", "") for d in allowed))
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.device.index not in (None, torch.cuda.current_device()):
            raise ValueError(f"{kernel}: {name} is on {t.device}, not the current "
                             f"device cuda:{torch.cuda.current_device()}")


def check_rows(kernel: str, name: str, n: int) -> None:
    if n < 1:
        raise ValueError(f"{kernel}: {name}={n}; the kernel needs at least one row")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fitted_threads(n_groups: int, n_sm: int) -> int:
    """Threads a block (64 .. 256, a multiple of 32) for a kernel that gives
    each thread one group of columns: the fewest that cover ``n_groups``
    with one block an SM, so a small call spreads evenly over the card and
    a large one takes full blocks."""
    per_sm = -(-n_groups // n_sm)
    return min(256, max(64, -(-per_sm // 32) * 32))


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(kernel: str, code: int) -> None:
    """Raise if the C entry reported a non-zero ``cudaGetLastError()``."""
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {code}")
