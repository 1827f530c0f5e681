"""Plain torch versions of the fused snapshot data plane.

These are what the CUDA kernels must match bit for bit: the publish version
is the piecemeal pipeline (zero scan → poly32 checksum → two masked
gathers), the restore version the piecemeal gather → checksum → scatter.
They run on whatever device their tensors are on; ``ops.py`` takes them for
CPU tensors, and ``chip_smoke.py`` compares the kernels with them on the
card.  Checksums are ``int32`` tensors holding the uint32 bits.
"""
import torch

from ..page_checksum.ref import page_checksum_ref


def fused_publish_ref(pages: torch.Tensor, ws_mask: torch.Tensor):
    """``(zero_bitmap bool[N], csum int32[N], hot (H, P), cold (C, P))`` for
    ``pages`` uint8 ``(N, P)``; hot/cold are compacted in ascending page order."""
    nz = pages.any(dim=1).to(torch.bool)   # any() of uint8 is uint8
    ws = ws_mask.to(device=pages.device, dtype=torch.bool)
    return ~nz, page_checksum_ref(pages), pages[nz & ws], pages[nz & ~ws]


def fused_restore_ref(dest: torch.Tensor, chunk: torch.Tensor, src_idx: torch.Tensor,
                      dst_idx: torch.Tensor) -> torch.Tensor:
    """In place ``dest[dst_idx[i]] = chunk[src_idx[i]]``; returns ``csum[M]``."""
    rows = chunk[src_idx]
    csum = page_checksum_ref(rows)
    dest[dst_idx] = rows
    return csum


def fused_restore_rows_ref(dest, segments) -> torch.Tensor:
    """The row-list form: for each segment ``(tensor, rows, dst)`` (``rows``
    None: ``arange``), :func:`fused_restore_ref` of ``tensor`` into ``dest``;
    returns the checksums of all rows in list order.  ``dest`` None checksums
    the rows without writing them (a verify-only launch's plain version)."""
    out = []
    for t, rows, dst in segments:
        src = (torch.arange(len(dst), device=t.device) if rows is None
               else torch.as_tensor(rows, dtype=torch.int64, device=t.device))
        if dest is None:
            out.append(page_checksum_ref(t[src]))
        else:
            out.append(fused_restore_ref(dest, t, src, torch.as_tensor(
                dst, dtype=torch.int64, device=dest.device)))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=None if dest is None else dest.device)
    return torch.cat(out)
