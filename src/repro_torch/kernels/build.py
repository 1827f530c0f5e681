"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel source under ``kernels/<name>/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/repro_torch_kernels/`` at the repository
root, named by a hash of the sources and flags, and are built at first use;
:func:`build` compiles several at once, one ``nvcc`` process per source, all
started together.  Importing this module needs neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_COMMON = (KERNELS_DIR / "snapshot_fuse" / "csrc" / "common.cuh",)
_ROWS = (*_COMMON, KERNELS_DIR / "snapshot_fuse" / "csrc" / "row_copy.cuh")
_FLASH = KERNELS_DIR / "flash_attention" / "csrc"
_SM90 = (_FLASH / "sm90_common.cuh",)
# library name -> (main source, headers it includes)
SOURCES: Dict[str, tuple] = {
    "fused_publish": (KERNELS_DIR / "snapshot_fuse" / "csrc" / "fused_publish.cu", _COMMON),
    "fused_restore": (KERNELS_DIR / "snapshot_fuse" / "csrc" / "fused_restore.cu", _ROWS),
    **{name: (KERNELS_DIR / name / "csrc" / f"{name}.cu", _COMMON)
       for name in ("zero_detect", "page_checksum", "page_gather")},
    "page_scatter": (KERNELS_DIR / "page_scatter" / "csrc" / "page_scatter.cu", _ROWS),
    "flash_attention": (_FLASH / "flash_attention.cu", ()),
    "flash_attention_sm90": (_FLASH / "flash_attention_sm90.cu", _SM90),
    "flash_attention_bwd": (_FLASH / "flash_attention_bwd.cu", ()),
    "flash_attention_bwd_sm90": (_FLASH / "flash_attention_bwd_sm90.cu", _SM90),
}

# ctypes argument types of the C entry points
PTR = ctypes.c_void_p
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
I32 = ctypes.c_int
F32 = ctypes.c_float

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: compiler output (``-Xptxas -v``: registers, shared memory, spills) per library
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled at first use "
                           "and need the CUDA toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    main, headers = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (main, *headers):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named library that is not built yet, all in parallel.

    Returns the seconds each compile took (empty when all were built).
    Raises ``RuntimeError`` with the compiler output if any compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n][0])],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[n] = (proc, tmp, out, time.perf_counter())
    seconds, errors = {}, []
    for n, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        build_logs[n] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {n} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, compiled first if needed (thread-safe)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return lib


def call(lib_name: str, fn_name: str, argtypes: Sequence, *args) -> None:
    """Call the C entry point ``fn_name`` of a kernel library (built first if
    needed); raise ``RuntimeError`` when it returns a CUDA error code."""
    lib = load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.aq_error_string.argtypes = [ctypes.c_int]
        lib.aq_error_string.restype = ctypes.c_char_p
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} ({lib.aq_error_string(rc).decode()})")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer value."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
