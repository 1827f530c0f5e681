"""Paged flat address space over model/server state, on a torch device.

A *StateImage* lays out a collection of named arrays into a single
page-aligned byte address space (the guest memory of a MicroVM snapshot).
The bytes live in one 1-D ``torch.uint8`` buffer on ``device``; every Aquifer
mechanism (zero-page elimination, hot/cold partitioning, the offset array,
page serving) operates on page indices of this address space.  Host arrays
enter and leave through numpy (``write_array`` / ``read_array``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

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
# Pluggable backend for the publish-path zero scan; the plain torch version
# is the default until the zero_detect kernel is ported.
ZeroScanFn = Callable[[torch.Tensor], torch.Tensor]

_zero_scan_backend: Optional[ZeroScanFn] = None


def torch_zero_scan(pages_matrix: torch.Tensor) -> torch.Tensor:
    """Plain version: vectorized any() over each page row."""
    return ~pages_matrix.any(dim=1).to(torch.bool)   # any() of uint8 is uint8


def set_zero_scan_backend(fn: Optional[ZeroScanFn]) -> Optional[ZeroScanFn]:
    """Install a process-wide zero-scan backend (None restores the plain
    version); returns the previous backend so callers can restore it."""
    global _zero_scan_backend
    prev = _zero_scan_backend
    _zero_scan_backend = fn
    return prev


def num_pages(nbytes: int) -> int:
    return -(-nbytes // PAGE_SIZE)


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
        itemsize = np.dtype(self.dtype).itemsize
        lo = self.byte_offset + start_elem * itemsize
        hi = self.byte_offset + stop_elem * itemsize
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
    def build(arrays: Mapping[str, np.ndarray], device="cuda") -> "StateImage":
        extents: List[ArrayExtent] = []
        offset = 0
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            extents.append(
                ArrayExtent(name, offset, arr.nbytes, tuple(arr.shape), str(arr.dtype))
            )
            offset += num_pages(arr.nbytes) * PAGE_SIZE
        img = StateImage.empty_like(Manifest(extents, offset // PAGE_SIZE),
                                    device=device)
        for name, arr in arrays.items():
            img.write_array(name, arr)
        return img

    @staticmethod
    def empty_like(manifest: Manifest, device="cuda") -> "StateImage":
        dev = resolve_device(device)
        return StateImage(manifest, torch.zeros(manifest.total_pages * PAGE_SIZE,
                                                dtype=torch.uint8, device=dev))

    # -- array views ------------------------------------------------------
    def write_array(self, name: str, arr: np.ndarray) -> None:
        e = self.manifest.by_name()[name]
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        if raw.nbytes != e.nbytes:
            raise ValueError(f"{name}: {raw.nbytes} != {e.nbytes}")
        self.buf[e.byte_offset : e.byte_offset + e.nbytes].copy_(torch.from_numpy(raw))

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
        fn = backend or _zero_scan_backend or torch_zero_scan
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
