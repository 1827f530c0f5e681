"""Paged flat address space over model/server state, on a torch device.

A *StateImage* lays out a collection of named arrays into a single
page-aligned byte address space (the guest memory of a MicroVM snapshot).
The bytes live in one 1-D ``torch.uint8`` buffer on ``device``; every Aquifer
mechanism (zero-page elimination, hot/cold partitioning, the offset array,
page serving) operates on page indices of this address space.  Arrays enter
as numpy arrays or as tensors (``write_array``; a tensor on the image's
device is copied there, never through the host) and leave as host numpy
(``read_array``) or as tensors on the image's device (``read_tensor``).
Manifest dtypes are numpy's names (``"float32"``, ``"bfloat16"``), as the
JAX package writes them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.zero_detect import zero_detect

PAGE_SIZE = 4096  # bytes — matches the paper's 4 KiB guest pages


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no card.

    Entry points default to ``"cuda"``; without a card they raise here
    instead of quietly running on the CPU (pass ``device="cpu"`` for that).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


# zero_scan(pages_matrix uint8[N, PAGE_SIZE]) -> bool[N] (True = all-zero).
# Pluggable backend for the publish-path zero scan; the default is
# kernel_zero_scan.
ZeroScanFn = Callable[[torch.Tensor], torch.Tensor]

_zero_scan_backend: Optional[ZeroScanFn] = None


def kernel_zero_scan(pages_matrix: torch.Tensor) -> torch.Tensor:
    """``kernels/zero_detect`` adapted to the ``ZeroScanFn`` signature, the
    counterpart of the reference's ``repro.core.pagestore.pallas_zero_scan``:
    the hand-written kernel on a CUDA matrix, its plain version on a CPU one."""
    return zero_detect(pages_matrix) != 0


def set_zero_scan_backend(fn: Optional[ZeroScanFn]) -> Optional[ZeroScanFn]:
    """Install a process-wide zero-scan backend (None restores
    :func:`kernel_zero_scan`); returns the previous backend so callers can
    restore it."""
    global _zero_scan_backend
    prev = _zero_scan_backend
    _zero_scan_backend = fn
    return prev


def num_pages(nbytes: int) -> int:
    return -(-nbytes // PAGE_SIZE)


def dtype_name(dtype) -> str:
    """The manifest's name of a numpy or torch dtype: ``"float32"``,
    ``"bfloat16"``, ``"int32"``, ..."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


def itemsize(name: str) -> int:
    """Bytes per element of a manifest dtype name (``"bfloat16"`` included,
    which numpy knows only through an extension)."""
    dt = getattr(torch, name, None)
    return dt.itemsize if isinstance(dt, torch.dtype) else np.dtype(name).itemsize


def _raw_bytes(arr) -> torch.Tensor:
    """A 1-D uint8 tensor over an array's bytes: a view of a contiguous
    tensor (any device), or of a numpy array's host memory."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().contiguous().reshape(-1).view(torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


@dataclasses.dataclass(frozen=True)
class ArrayExtent:
    """Placement of one named array inside the flat address space."""

    name: str
    byte_offset: int          # page-aligned start
    nbytes: int               # payload bytes (may end mid-page; tail is zero)
    shape: Tuple[int, ...]
    dtype: str

    @property
    def first_page(self) -> int:
        return self.byte_offset // PAGE_SIZE

    @property
    def page_count(self) -> int:
        return num_pages(self.nbytes)

    def pages(self) -> range:
        return range(self.first_page, self.first_page + self.page_count)

    def element_pages(self, start_elem: int, stop_elem: int) -> range:
        """Pages covering elements [start, stop) of the flattened array."""
        size = itemsize(self.dtype)
        lo = self.byte_offset + start_elem * size
        hi = self.byte_offset + stop_elem * size
        return range(lo // PAGE_SIZE, num_pages(hi) if hi % PAGE_SIZE else hi // PAGE_SIZE)

    def row_pages(self, row: int, row_elems: int) -> range:
        """Pages covering one leading-axis row (e.g. one embedding row)."""
        return self.element_pages(row * row_elems, (row + 1) * row_elems)


@dataclasses.dataclass
class Manifest:
    """Address-space layout: the restore-time 'machine state' index."""

    extents: List[ArrayExtent]
    total_pages: int

    def by_name(self) -> Dict[str, ArrayExtent]:
        return {e.name: e for e in self.extents}

    def to_dict(self) -> dict:
        return {
            "total_pages": self.total_pages,
            "extents": [dataclasses.asdict(e) for e in self.extents],
        }

    @staticmethod
    def from_dict(d: dict) -> "Manifest":
        return Manifest(
            extents=[ArrayExtent(**{**e, "shape": tuple(e["shape"])}) for e in d["extents"]],
            total_pages=d["total_pages"],
        )


class StateImage:
    """A flat, paged byte image of named arrays (the 'guest memory').

    Arrays are laid out back-to-back, each starting on a page boundary so a
    page never spans two arrays.  ``buf`` is a 1-D ``torch.uint8`` tensor on
    the image's device.
    """

    def __init__(self, manifest: Manifest, buf: torch.Tensor):
        if buf.dtype != torch.uint8 or buf.dim() != 1:
            raise ValueError(f"StateImage buffer must be 1-D uint8, got "
                             f"{buf.dtype} with {buf.dim()} dims")
        self.manifest = manifest
        self.buf = buf

    @property
    def device(self) -> torch.device:
        return self.buf.device

    # -- construction -----------------------------------------------------
    @staticmethod
    def layout(arrays: Mapping[str, object]) -> Manifest:
        """The manifest :meth:`build` lays ``arrays`` (numpy arrays or
        tensors) out by, without allocating the image."""
        extents: List[ArrayExtent] = []
        offset = 0
        for name, arr in arrays.items():
            if isinstance(arr, torch.Tensor):     # a 0-d array takes one element, as numpy's
                shape = tuple(arr.shape) or (1,)
                nbytes, dtype = arr.numel() * arr.element_size(), arr.dtype
            else:
                arr = np.ascontiguousarray(arr)
                shape, nbytes, dtype = tuple(arr.shape), arr.nbytes, arr.dtype
            extents.append(ArrayExtent(name, offset, nbytes, shape, dtype_name(dtype)))
            offset += num_pages(nbytes) * PAGE_SIZE
        return Manifest(extents, offset // PAGE_SIZE)

    @staticmethod
    def build(arrays: Mapping[str, object], device="cuda") -> "StateImage":
        """An image of ``arrays`` (numpy arrays or tensors) on ``device``;
        tensors already there are copied on the device."""
        img = StateImage.empty_like(StateImage.layout(arrays), device=device)
        for name, arr in arrays.items():
            img.write_array(name, arr)
        return img

    @staticmethod
    def empty_like(manifest: Manifest, device="cuda") -> "StateImage":
        dev = resolve_device(device)
        return StateImage(manifest, torch.zeros(manifest.total_pages * PAGE_SIZE,
                                                dtype=torch.uint8, device=dev))

    # -- array views ------------------------------------------------------
    def write_array(self, name: str, arr) -> None:
        """Copy ``arr`` (a numpy array, or a tensor on any device) into its
        extent."""
        e = self.manifest.by_name()[name]
        raw = _raw_bytes(arr)
        if raw.numel() != e.nbytes:
            raise ValueError(f"{name}: {raw.numel()} != {e.nbytes}")
        self.buf[e.byte_offset : e.byte_offset + e.nbytes].copy_(raw)

    def read_tensor(self, name: str) -> torch.Tensor:
        """The array as a tensor of its dtype and shape on the image's
        device: a view of the image's bytes, not a copy."""
        e = self.manifest.by_name()[name]
        raw = self.buf[e.byte_offset : e.byte_offset + e.nbytes]
        return raw.view(torch_dtype(e.dtype)).reshape(e.shape)

    def read_array(self, name: str) -> np.ndarray:
        e = self.manifest.by_name()[name]
        raw = self.buf[e.byte_offset : e.byte_offset + e.nbytes].cpu().numpy()
        return raw.view(np.dtype(e.dtype)).reshape(e.shape)

    # -- page views -------------------------------------------------------
    @property
    def total_pages(self) -> int:
        return self.manifest.total_pages

    def page(self, idx: int) -> torch.Tensor:
        return self.buf[idx * PAGE_SIZE : (idx + 1) * PAGE_SIZE]

    def pages_matrix(self) -> torch.Tensor:
        """``(total_pages, PAGE_SIZE)`` view of ``buf`` (not a copy)."""
        return self.buf.view(self.total_pages, PAGE_SIZE)

    def write_page(self, idx: int, data: torch.Tensor) -> None:
        if data.numel() * data.element_size() != PAGE_SIZE:
            raise ValueError(f"page write of {data.numel()} elements")
        self.buf[idx * PAGE_SIZE : (idx + 1) * PAGE_SIZE].copy_(
            data.reshape(-1).view(torch.uint8))

    def zero_page_bitmap(self, backend: Optional[ZeroScanFn] = None) -> np.ndarray:
        """bool[total_pages] on the host; True where the page is all zero."""
        fn = backend or _zero_scan_backend or kernel_zero_scan
        out = fn(self.pages_matrix()).to(torch.bool).cpu().numpy()
        if out.shape != (self.total_pages,):
            raise ValueError(f"zero-scan backend returned shape {out.shape}")
        return out


def runs_from_pages(pages: Sequence[int]) -> List[Tuple[int, int]]:
    """Collapse a sorted page-index set into (start, length) runs."""
    out: List[Tuple[int, int]] = []
    it = iter(sorted(set(pages)))
    try:
        start = prev = next(it)
    except StopIteration:
        return out
    for p in it:
        if p == prev + 1:
            prev = p
            continue
        out.append((start, prev - start + 1))
        start = prev = p
    out.append((start, prev - start + 1))
    return out


def pages_from_runs(runs: Iterable[Tuple[int, int]]) -> List[int]:
    out: List[int] = []
    for s, n in runs:
        out.extend(range(s, s + n))
    return out
