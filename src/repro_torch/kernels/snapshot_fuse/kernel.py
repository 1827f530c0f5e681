"""ctypes bindings of the hand-written CUDA snapshot kernels (``csrc/*.cu``).

``publish_classify`` + ``publish_compact`` are the fused publish sweep
(replacing ``fused_publish_pallas``), ``restore`` the fused
gather→checksum→scatter (replacing ``fused_restore_pallas``).  These take
CUDA tensors that ``ops.py`` has already checked and allocated, launch on
PyTorch's current stream without synchronising, and raise when the launch
is refused.  The libraries are compiled at first call (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    ("fused_publish", "aq_publish_classify"): (_P, _P, _P, _I64, _P, _P, _P, _P, _P, _P),
    ("fused_publish", "aq_publish_compact"): (_P, _P, _P, _I64, _P, _P, _P),
    ("fused_restore", "aq_fused_restore"): (_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P),
}


def _fn(lib_name: str, fn_name: str):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(_SIGNATURES[(lib_name, fn_name)])
        fn.restype = ctypes.c_int
        lib.aq_error_string.argtypes = [ctypes.c_int]
        lib.aq_error_string.restype = ctypes.c_char_p
    return fn, lib


def _call(lib_name: str, fn_name: str, *args) -> None:
    fn, lib = _fn(lib_name, fn_name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({lib.aq_error_string(rc).decode()})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def publish_classify(pages: torch.Tensor, ws: torch.Tensor, weights: torch.Tensor,
                     zero: torch.Tensor, csum: torch.Tensor, cls: torch.Tensor,
                     pos: torch.Tensor, counts: torch.Tensor) -> None:
    """Steps (A)+(B): per-page zero flag, checksum and class, then the
    destination row of each page and ``counts = [n_hot, n_cold]``."""
    _call("fused_publish", "aq_publish_classify", _ptr(pages), _ptr(ws), _ptr(weights),
          pages.shape[0], _ptr(zero), _ptr(csum), _ptr(cls), _ptr(pos), _ptr(counts),
          _stream(pages))


def publish_compact(pages: torch.Tensor, cls: torch.Tensor, pos: torch.Tensor,
                    hot: torch.Tensor, cold: torch.Tensor) -> None:
    """Step (C): copy each non-zero page to its row of ``hot`` or ``cold``."""
    _call("fused_publish", "aq_publish_compact", _ptr(pages), _ptr(cls), _ptr(pos),
          pages.shape[0], _ptr(hot), _ptr(cold), _stream(pages))


def restore(dest: torch.Tensor, chunk: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            weights: torch.Tensor, expected: Optional[torch.Tensor], csum: torch.Tensor,
            n_bad: Optional[torch.Tensor]) -> None:
    """``dest[dst[i]] = chunk[src[i]]``, ``csum[i]`` = its checksum, and
    ``n_bad`` = rows whose checksum differs from ``expected[dst[i]]``."""
    _call("fused_restore", "aq_fused_restore", _ptr(dest), _ptr(chunk), _ptr(src), _ptr(dst),
          src.shape[0], _ptr(weights), _ptr(expected), _ptr(csum), _ptr(n_bad),
          _stream(dest))
