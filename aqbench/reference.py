"""The plain reference: what a publish must store and a restore must install.

Plain PyTorch and NumPy over plain tensors and numbers.  It imports nothing
of the program: the harness hands it the benchmark's own images (made from
the seed by ``gen.py``), the tier arenas' bytes and the records the program
wrote, and it works out again everything the program derived from the
images (zero pages, hot and cold classes, the offset array, the stored
bytes, the checksums, the distinct contents a dedup pool must hold).  Every
function returns counts of disagreements; a sound program gives 0 in each.

The snapshot format it holds the program to (the paper's §3.2):

* one uint64 offset-array slot a guest page: all ones for a zero page (never
  stored), else the tier tag in the top two bits (0 CXL for hot pages,
  1 RDMA for cold ones) and a byte offset in the low 62;
* private layout: hot pages rank-compacted from ``hot_off``, cold pages from
  ``rdma_off``, offsets relative to those; dedup layout: absolute offsets
  into the tier's content-addressed store;
* the publish-time checksum of every page: the polynomial hash
  sum_i lane_i * P^(E-1-i) mod 2^32 over its E little-endian uint32 lanes,
  P = 0x01000193.
"""
from __future__ import annotations

import numpy as np
import torch

PAGE = 4096
ZERO_SLOT = np.uint64(0xFFFF_FFFF_FFFF_FFFF)
TAG_SHIFT = np.uint64(62)
OFF_MASK = np.uint64((1 << 62) - 1)
TAG_CXL, TAG_RDMA = 0, 1
POLY_P = 0x01000193
FP_P = 0x9E3779B1            # the fingerprint's second base
MASK32 = 0xFFFFFFFF
BLOCK = 4096                 # rows a block of the int64 arithmetic
FP_BLOCK = 16384             # pages a block of the page fingerprints
FP_WEIGHTS = np.random.default_rng(0xA9B1F00D).integers(
    -(1 << 63), (1 << 63) - 1, size=PAGE // 8, dtype=np.int64) | 1


def _weights(p: int, lanes: int, device) -> torch.Tensor:
    w = np.empty(lanes, dtype=np.int64)
    acc = 1
    for i in range(lanes - 1, -1, -1):
        w[i] = acc
        acc = (acc * p) & MASK32
    return torch.from_numpy(w).to(device)


def poly32(rows: torch.Tensor, p: int = POLY_P) -> torch.Tensor:
    """int64[N] in [0, 2^32): the polynomial hash of each uint8 row."""
    n, width = rows.shape
    w = _weights(p, width // 4, rows.device)
    out = torch.empty(n, dtype=torch.int64, device=rows.device)
    for r0 in range(0, n, BLOCK):
        lanes = rows[r0:r0 + BLOCK].contiguous().view(torch.int32).to(torch.int64) & MASK32
        out[r0:r0 + BLOCK] = ((lanes * w) & MASK32).sum(dim=1) & MASK32
    return out


def fingerprints(rows: torch.Tensor) -> torch.Tensor:
    """int64[N]: two polynomial hashes of each row with different bases, as
    one 64-bit number (distinct rows collide with odds near 2^-64)."""
    return (poly32(rows, POLY_P) << 32) | poly32(rows, FP_P)


def classes(buf: torch.Tensor, hot: torch.Tensor) -> dict:
    """The paper's page classes of an image and its working set."""
    nonzero = buf.view(-1, PAGE).any(dim=1).to(torch.bool)   # any() of uint8 is uint8
    return {"zero": ~nonzero, "hot": torch.nonzero(nonzero & hot).view(-1),
            "cold": torch.nonzero(nonzero & ~hot).view(-1)}


def expected_slots(total: int, cls: dict) -> np.ndarray:
    """The private layout's offset array for these classes."""
    oa = np.full(total, ZERO_SLOT, dtype=np.uint64)
    hot, cold = cls["hot"].cpu().numpy(), cls["cold"].cpu().numpy()
    oa[hot] = (np.uint64(TAG_CXL) << TAG_SHIFT) | (np.arange(hot.size, dtype=np.uint64)
                                                   * np.uint64(PAGE))
    oa[cold] = (np.uint64(TAG_RDMA) << TAG_SHIFT) | (np.arange(cold.size, dtype=np.uint64)
                                                     * np.uint64(PAGE))
    return oa


def _rows_at(arena: torch.Tensor, byte_offs: np.ndarray) -> torch.Tensor:
    rows = arena[: arena.numel() // PAGE * PAGE].view(-1, PAGE)
    return rows[torch.from_numpy((byte_offs // PAGE).astype(np.int64)).to(arena.device)]


def _mismatched_rows(a: torch.Tensor, b: torch.Tensor) -> int:
    bad = 0
    for r0 in range(0, a.shape[0], BLOCK):
        bad += int((a[r0:r0 + BLOCK] != b[r0:r0 + BLOCK]).any(dim=1).sum())
    return bad


def check_snapshot(rec: dict, cxl: torch.Tensor, rdma: torch.Tensor, buf: torch.Tensor,
                   hot: torch.Tensor) -> dict:
    """Disagreements of one stored snapshot with the image it was published
    from.  ``rec``: the program's record as plain values (``total_pages``,
    ``n_hot``, ``n_cold``, ``n_zero``, ``oa_off``, ``hot_off``, ``rdma_off``,
    ``dedup``, ``checksums``: int32 tensor or None); ``cxl`` / ``rdma``: the
    tiers' arenas as uint8 tensors."""
    total = buf.numel() // PAGE
    cls = classes(buf, hot)
    rows = buf.view(-1, PAGE)
    out = {"counts": int(rec["total_pages"] != total) + int(rec["n_hot"] != cls["hot"].numel())
           + int(rec["n_cold"] != cls["cold"].numel())
           + int(rec["n_zero"] != int(cls["zero"].sum()))}
    oa = cxl[rec["oa_off"]:rec["oa_off"] + total * 8].cpu().numpy().view(np.uint64)
    zero_np = cls["zero"].cpu().numpy()
    if rec["dedup"]:
        tags = oa >> TAG_SHIFT
        want_tag = np.full(total, 255, dtype=np.uint64)
        want_tag[cls["hot"].cpu().numpy()] = TAG_CXL
        want_tag[cls["cold"].cpu().numpy()] = TAG_RDMA
        slot_bad = np.where(zero_np, oa != ZERO_SLOT, (oa == ZERO_SLOT) | (tags != want_tag))
    else:
        slot_bad = oa != expected_slots(total, cls)
    out["slots"] = int(slot_bad.sum())
    bad_bytes = 0
    for name, arena, tag, base in (("hot", cxl, TAG_CXL, rec["hot_off"]),
                                   ("cold", rdma, TAG_RDMA, rec["rdma_off"])):
        pages = cls[name]
        if not pages.numel():
            continue
        p_np = pages.cpu().numpy()
        offs = oa[p_np]
        ok = (offs != ZERO_SLOT) & ((offs >> TAG_SHIFT) == np.uint64(tag))
        offs = (offs & OFF_MASK).astype(np.int64) + (0 if rec["dedup"] else int(base))
        ok &= offs + PAGE <= arena.numel()
        bad_bytes += int((~ok).sum())
        sel = np.flatnonzero(ok)
        if sel.size:
            bad_bytes += _mismatched_rows(_rows_at(arena, offs[sel]),
                                          rows[pages[torch.from_numpy(sel).to(pages.device)]])
    out["stored_bytes"] = bad_bytes
    if rec["checksums"] is None:
        out["checksums"] = total
    else:
        want = poly32(rows)
        got = rec["checksums"].to(torch.int64) & MASK32
        out["checksums"] = int((got.to(want.device) != want).sum())
    return out


def page_fps(buf: torch.Tensor) -> torch.Tensor:
    """int64[N]: a fingerprint of each 4 KiB page of ``buf``, the sum, with
    wrap-around, of its 512 int64 words each times a fixed odd weight.  Two
    pages that differ in one word always differ in it (an odd weight is
    invertible mod 2^64); pages that differ more collide with odds near
    2^-63."""
    rows = buf.view(torch.int64).view(-1, PAGE // 8)
    w = torch.from_numpy(FP_WEIGHTS).to(buf.device)
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=buf.device)
    for r0 in range(0, rows.shape[0], FP_BLOCK):
        out[r0:r0 + FP_BLOCK] = (rows[r0:r0 + FP_BLOCK] * w).sum(dim=1)
    return out


def check_restore(got_fps: np.ndarray, present: np.ndarray, want_fps: np.ndarray, cls: dict,
                  touched: np.ndarray, full: bool) -> dict:
    """Disagreements of one restored instance with its image: pages that
    must be present and are not (the hot and zero pages and the guest's
    touches, or every page after an eager restore), and present pages whose
    bytes differ (``got_fps``: the instance's page fingerprints, taken
    before its release; ``want_fps``: the image's; ``cls``: its classes)."""
    need = np.zeros(present.size, dtype=bool)
    if full:
        need[:] = True
    else:
        need[cls["zero"].cpu().numpy()] = True
        need[cls["hot"].cpu().numpy()] = True
        need[touched] = True
    return {"missing": int((need & ~present).sum()),
            "bytes": int((present & (got_fps != want_fps)).sum())}


def distinct_pages(rows_by_tier: dict) -> dict:
    """Distinct contents a content-addressed pool must hold, per tier:
    ``rows_by_tier[tier]`` is a list of uint8 row matrices, one a snapshot."""
    out = {}
    for tier, mats in rows_by_tier.items():
        fps = [fingerprints(m) for m in mats if m.shape[0]]
        out[tier] = int(torch.unique(torch.cat(fps)).numel()) if fps else 0
    return out


def dedup_refs(slots_by_snapshot: list, refcounts: dict) -> int:
    """References that disagree with the live offset arrays: for each
    stored offset, the store's refcount against the number of slots that
    point at it (``slots_by_snapshot``: int64 arrays of absolute offsets)."""
    want: dict = {}
    for offs in slots_by_snapshot:
        u, c = np.unique(offs, return_counts=True)
        for o, k in zip(u.tolist(), c.tolist()):
            want[o] = want.get(o, 0) + k
    keys = set(want) | set(refcounts)
    return sum(1 for k in keys if want.get(k, 0) != refcounts.get(k, 0))
