"""Content-addressed snapshot page store (§3.6 extension), on a torch device.

Snapshots of fine-tuned variants share base-model pages.  The offset array
can point anywhere in a tier, so dedup integrates at publish time: pages are
content-hashed (FNV-1a 64-bit by default; :func:`poly32_hash_fn`, the
``page_checksum`` kernel, plugs in behind the same ``hash_fn`` signature)
and identical pages are stored ONCE with a reference count.

Refcount protocol:

* ``put_pages`` on publish — one increment per offset-array slot that will
  point at the page;
* ``release_offsets`` when an offset array is retired — decrements only;
* the tier byte range is freed exactly when a page's refcount reaches zero.

A hash match NEVER shares a page on its own: the candidate's bytes are
compared with the stored bytes first (a hash collision gets a separate
physical page in the same bucket).  ``hash_fn`` is an injectable seam, so
tests force collisions deliberately.

Batched put.  The reference decides row by row in Python, with a byte
compare on every hash match and one tier write per new page.  Here the page
bytes stay on the tier's device and only the decision runs on the host:

1. the batch's hashes cross to the host in one copy;
2. rows that share a hash with another row of the batch are sorted into
   content classes by batched byte compares on the device, against the
   first unclassed row of their hash group, one round per distinct content
   in the group (one round unless hashes truly collide);
3. each class's first row is compared, in one batched pass, with every
   stored page of its hash bucket; the first equal page in bucket order is
   the class's match;
4. classes without a match take new pages, allocated first-fit in row order
   (``MemoryTier.alloc_pages``), so the offsets are the reference's;
5. all new pages are written by ONE ``page_scatter`` launch into the tier's
   page rows.

This yields the reference's offsets, refcounts, bucket contents and order,
``_hash_of``, quarantine set and stats for any input, including forced
collisions, duplicate rows within a batch, a mid-batch ``AllocError`` and an
injected write fault (both roll the batch back as the reference does).

Hashes held in int32 / int64 tensors or arrays are read as the uint32 /
uint64 bits they hold, so bucket keys equal the reference's.

Invariant I6 (refcount conservation): each store refcount equals the number
of live offset-array slots pointing at it.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.page_checksum import page_checksum
from ..kernels.page_scatter import page_scatter
from .faults import TierFaultError
from .pagestore import PAGE_SIZE
from .pool import MemoryTier

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)     # 2**40 + 0x1B3

# hash_fn(pages uint8[N, PAGE_SIZE] tensor) -> integer tensor or array [N]
HashFn = Callable[[torch.Tensor], object]

_M32 = 0xFFFFFFFF
_CMP_PAIRS = 4096     # row pairs per compare pass: 2 x 16 MiB of gathered rows


def fnv1a_pages(pages_matrix: torch.Tensor) -> torch.Tensor:
    """FNV-1a-64 per row over its little-endian u64 lanes, as an int64
    tensor holding the uint64 bits of the reference's ``fnv1a_pages``.

    torch has no uint64 arithmetic, so the hash is carried as two 32-bit
    halves in int64: with ``FNV_PRIME = 2**40 + 0x1B3``,
    ``h * P = h * 0x1B3 + (h << 40)  (mod 2**64)``, and no intermediate
    exceeds 2**42."""
    n = pages_matrix.shape[0]
    words = pages_matrix.reshape(n, -1).contiguous().view(torch.int32).to(torch.int64) & _M32
    lo_w, hi_w = words[:, 0::2], words[:, 1::2]
    dev = pages_matrix.device
    lo = torch.full((n,), int(FNV_OFFSET) & _M32, dtype=torch.int64, device=dev)
    hi = torch.full((n,), int(FNV_OFFSET) >> 32, dtype=torch.int64, device=dev)
    for j in range(lo_w.shape[1]):
        lo = lo ^ lo_w[:, j]
        hi = hi ^ hi_w[:, j]
        plo = lo * 0x1B3
        hi = (hi * 0x1B3 + (plo >> 32) + ((lo & 0xFFFFFF) << 8)) & _M32
        lo = plo & _M32
    hi = hi - ((hi >> 31) << 32)      # the high word as a signed int32
    return hi * (1 << 32) + lo


def fnv1a_page(page) -> int:
    """FNV-1a-64 of one 4 KiB page (tensor of any shape), as an unsigned int."""
    return int(fnv1a_pages(_as_rows(page, None))[0]) % (1 << 64)


def poly32_hash_fn(pages_matrix: torch.Tensor) -> torch.Tensor:
    """The ``page_checksum`` polynomial hash (the hand-written kernel on a
    CUDA matrix, its plain version on a CPU one) behind the ``HashFn``
    signature: the counterpart of the reference's ``dedup.pallas_hash_fn``.
    Weaker (32-bit) than FNV-1a-64, which is fine: the store byte-verifies
    every hash match before sharing."""
    return page_checksum(pages_matrix)


# The fused publish sweep's checksum column IS this hash, so a store hashing
# with it can be handed the precomputed values (put_pages(..., hashes=...))
# and skip its own pass over the batch.
poly32_hash_fn.is_poly32 = True


def _as_rows(pages: torch.Tensor, device: Optional[torch.device]) -> torch.Tensor:
    """Pages (any shape and dtype) as contiguous uint8 ``(N, PAGE_SIZE)``
    rows on ``device`` (None: where they are)."""
    t = pages.contiguous().reshape(-1).view(torch.uint8).reshape(-1, PAGE_SIZE)
    return t if device is None else t.to(device)


def _host_hashes(hashes, n: int) -> np.ndarray:
    """Hashes on the host (one device-to-host copy), as unsigned integers."""
    if isinstance(hashes, torch.Tensor):
        hashes = hashes.detach().cpu().numpy()
    h = np.asarray(hashes).reshape(-1)
    if h.dtype == np.int32:
        h = h.view(np.uint32)
    elif h.dtype == np.int64:
        h = h.view(np.uint64)
    assert h.shape[0] == n, f"precomputed hashes: {h.shape[0]} != {n} rows"
    return h


def _rows_equal(a: torch.Tensor, ia: np.ndarray, b: torch.Tensor, ib: np.ndarray) -> np.ndarray:
    """``a[ia[k]] == b[ib[k]]`` bytewise for every pair k, on the rows'
    device; the answers cross to the host in one copy."""
    out = torch.empty(ia.size, dtype=torch.bool, device=a.device)
    for s in range(0, ia.size, _CMP_PAIRS):
        ta = torch.from_numpy(ia[s : s + _CMP_PAIRS]).to(a.device)
        tb = torch.from_numpy(ib[s : s + _CMP_PAIRS]).to(b.device)
        out[s : s + _CMP_PAIRS] = (a[ta] == b[tb]).all(dim=1)
    return out.cpu().numpy()


class DedupStore:
    """Content-addressed, refcounted page store inside one tier.

    The store owns its pages' tier allocations: callers never ``tier.free``
    a deduped page directly — they :meth:`release` their reference and the
    store frees the byte range when the last reference drops.
    """

    def __init__(self, tier: MemoryTier, hash_fn: Optional[HashFn] = None):
        self.tier = tier
        tier.dedup_store = self   # checksum repair resolves store from tier
        self.hash_fn = hash_fn or fnv1a_pages
        # hash -> [offset, ...]: collisions coexist in one bucket, each
        # offset holding distinct bytes (verified before every share)
        self._buckets: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}          # offset -> refcount
        self._hash_of: Dict[int, int] = {}       # offset -> hash (for release)
        self._quarantined: set = set()           # offsets barred from sharing
        self._lock = threading.RLock()
        self.stats = {"unique": 0, "dedup_hits": 0, "collisions": 0,
                      "released": 0, "freed": 0, "quarantined": 0,
                      "rematerialized": 0}
        # host wall seconds spent deciding put_pages batches (steps 2-4 and
        # the bookkeeping; hashing and the store write are not included)
        self.decide_s = 0.0

    def _hashes(self, mat: torch.Tensor, hashes=None) -> np.ndarray:
        return _host_hashes(self.hash_fn(mat) if hashes is None else hashes, mat.shape[0])

    # -- internal (lock held) -------------------------------------------------
    def _resolve(self, mat: torch.Tensor, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """For each row: the stored offset it matches (-1 for none) and its
        class leader, the first row of the batch with the same hash and
        bytes (itself when it is the first)."""
        n = h.shape[0]
        uniq, inv, counts = np.unique(h, return_inverse=True, return_counts=True)
        leader = np.arange(n, dtype=np.int64)
        # content classes inside the batch, one round per distinct content
        todo = np.flatnonzero(counts[inv] > 1)
        todo = todo[np.argsort(inv[todo], kind="stable")]      # by hash, then row
        while todo.size:
            g = inv[todo]
            first = np.concatenate([[True], g[1:] != g[:-1]])
            rep = todo[np.maximum.accumulate(np.where(first, np.arange(todo.size), 0))]
            eq = np.zeros(todo.size, dtype=bool)
            cand = ~first
            if cand.any():
                eq[cand] = _rows_equal(mat, todo[cand], mat, rep[cand])
            done = first | eq
            leader[todo[done]] = rep[done]
            todo = todo[~done]
        # each class leader against its bucket's stored pages, in bucket order
        match = np.full(n, -1, dtype=np.int64)
        keys = uniq.tolist()
        pair_row: List[int] = []
        pair_off: List[int] = []
        leaders = np.flatnonzero(leader == np.arange(n))
        for r, g in zip(leaders.tolist(), inv[leaders].tolist()):
            bucket = self._buckets.get(keys[g])
            if bucket:
                pair_row.extend([r] * len(bucket))
                pair_off.extend(bucket)
        if pair_row:
            pr = np.asarray(pair_row, dtype=np.int64)
            po = np.asarray(pair_off, dtype=np.int64)
            eq = _rows_equal(mat, pr, self.tier.page_rows(), po // PAGE_SIZE)
            hit_r, hit_o = pr[eq], po[eq]
            first_hit = np.unique(hit_r, return_index=True)[1]
            match[hit_r[first_hit]] = hit_o[first_hit]
        return match[leader], leader

    # -- write side -----------------------------------------------------------
    def put_pages(self, pages_matrix, hashes=None) -> np.ndarray:
        """Store (or reference) every row; returns int64 tier byte offsets.

        On a mid-batch tier ``AllocError`` (or an injected write fault) the
        rows already referenced by THIS call are released again, so a failed
        put leaves the store unchanged.

        ``hashes`` MUST be this store's own ``hash_fn`` outputs for exactly
        these rows (the fused publish sweep precomputes them in the same
        pass that compacts the pages); foreign hashes would split identical
        content across buckets and silently disable sharing.
        """
        mat = _as_rows(pages_matrix, self.tier.device)
        n = mat.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        h = self._hashes(mat, hashes)
        with self._lock:
            t0 = time.perf_counter()
            match, leader = self._resolve(mat, h)
            new_rows = np.flatnonzero((match < 0) & (leader == np.arange(n)))
            new_offs = self.tier.alloc_pages(new_rows.size)
            fail, err = n, None           # rows before `fail` are placed
            if new_offs.size < new_rows.size:
                fail = int(new_rows[new_offs.size])
                err = self.tier._alloc_error(PAGE_SIZE)
            fi = self.tier.fault_injector
            if fi is not None:
                for t, off in enumerate(new_offs.tolist()):
                    try:
                        fi.check_write(self.tier.name, off, PAGE_SIZE)
                    except TierFaultError as e:
                        # as in the reference, the page whose write failed
                        # stays allocated; later rows never allocated theirs
                        for later in new_offs[t + 1 :].tolist():
                            self.tier.free(later, PAGE_SIZE)
                        fail, err = int(new_rows[t]), e
                        new_offs = new_offs[:t]
                        break
            new_rows = new_rows[: new_offs.size]
            slot = np.full(n, -1, dtype=np.int64)
            slot[new_rows] = new_offs
            offs = np.where(match >= 0, match, slot[leader])
            if new_rows.size:
                assert not (new_offs % PAGE_SIZE).any(), "store pages must be page-aligned"
                page_scatter(self.tier.page_rows(), mat, new_offs // PAGE_SIZE,
                             src_indices=new_rows)
            self._record(offs[:fail], h, new_rows)
            self.decide_s += time.perf_counter() - t0
            if err is not None:
                for off in offs[:fail].tolist():
                    self._release_locked(off)
                raise err
        return offs

    def _record(self, offs: np.ndarray, h: np.ndarray, new_rows: np.ndarray) -> None:
        """Bookkeeping of placed rows ``offs`` (rows ``0..len(offs)-1``):
        bucket appends in row order for the new pages, refcounts for all."""
        for off, key in zip(offs[new_rows].tolist(), h[new_rows].tolist()):
            bucket = self._buckets.setdefault(key, [])
            if bucket:
                self.stats["collisions"] += 1
            bucket.append(off)
            self._refs[off] = 1
            self._hash_of[off] = key
        self.stats["unique"] += int(new_rows.size)
        is_new = np.zeros(offs.size, dtype=bool)
        is_new[new_rows] = True
        hits = offs[~is_new]
        if hits.size:
            uo, uc = np.unique(hits, return_counts=True)
            for off, c in zip(uo.tolist(), uc.tolist()):
                self._refs[off] += c
            self.stats["dedup_hits"] += int(hits.size)

    def put(self, page) -> int:
        """Store (or reference) a single page; returns its tier byte offset."""
        return int(self.put_pages(page)[0])

    def probe_new_bytes(self, pages_matrix) -> int:
        """Tier bytes :meth:`put_pages` would NEWLY allocate for this batch —
        distinct page contents not already stored — without storing anything.
        The capacity manager admits dedup publishes on this marginal size."""
        mat = _as_rows(pages_matrix, self.tier.device)
        n = mat.shape[0]
        if n == 0:
            return 0
        h = self._hashes(mat)
        with self._lock:
            match, leader = self._resolve(mat, h)
        return int(np.count_nonzero((match < 0) & (leader == np.arange(n)))) * PAGE_SIZE

    # -- release side ---------------------------------------------------------
    def _release_locked(self, offset: int) -> None:
        rc = self._refs.get(offset)
        if rc is None:
            raise ValueError(f"release of unknown dedup offset {offset}")
        self.stats["released"] += 1
        if rc > 1:
            self._refs[offset] = rc - 1
            return
        h = self._hash_of.pop(offset)
        del self._refs[offset]
        bucket = self._buckets.get(h, [])
        if offset in bucket:          # a quarantined offset left its bucket
            bucket.remove(offset)
        if not bucket:
            self._buckets.pop(h, None)
        self._quarantined.discard(offset)
        self.tier.free(offset, PAGE_SIZE)
        self.stats["freed"] += 1

    def release(self, offset: int) -> None:
        """Drop one reference; frees the tier page at refcount zero."""
        with self._lock:
            self._release_locked(int(offset))

    def release_offsets(self, offsets) -> None:
        """Batch :meth:`release` (an offset array being retired: each slot
        is one reference, so duplicates decrement once per occurrence)."""
        with self._lock:
            for off in np.asarray(offsets, dtype=np.int64).tolist():
                self._release_locked(off)

    def drop(self, page) -> None:
        """Release one reference by CONTENT (hash + byte-match); unknown
        pages are ignored."""
        mat = _as_rows(page, self.tier.device)[:1]
        h = self._hashes(mat)
        with self._lock:
            match, _ = self._resolve(mat, h)
            if match[0] >= 0:
                self._release_locked(int(match[0]))

    # -- checksum repair --------------------------------------------------------
    def quarantine(self, offset: int) -> bool:
        """Bar a suspect offset from NEW sharing: its hash-bucket entry is
        removed so no future publish matches it, while existing references
        stay (I6 is untouched).  Returns False for offsets the store does
        not own or that are already quarantined."""
        offset = int(offset)
        with self._lock:
            h = self._hash_of.get(offset)
            if h is None or offset in self._quarantined:
                return False
            self._quarantined.add(offset)
            bucket = self._buckets.get(h, [])
            if offset in bucket:
                bucket.remove(offset)
            if not bucket:
                self._buckets.pop(h, None)
            self.stats["quarantined"] += 1
            return True

    def rematerialize(self, offset: int, page_row) -> None:
        """Scrub a quarantined offset with verified-clean bytes and restore
        its bucket entry so the content is shareable again.  The bytes MUST
        hash to the offset's recorded hash."""
        offset = int(offset)
        mat = _as_rows(page_row, self.tier.device)[:1]
        h = int(self._hashes(mat)[0])
        with self._lock:
            if offset not in self._quarantined:
                raise ValueError(f"offset {offset} is not quarantined")
            if h != self._hash_of[offset]:
                raise ValueError(
                    f"rematerialize hash mismatch at offset {offset}: "
                    f"{h:#x} != recorded {self._hash_of[offset]:#x}")
            self.tier.write(offset, mat[0])
            self._quarantined.discard(offset)
            self._buckets.setdefault(h, []).append(offset)
            self.stats["rematerialized"] += 1

    def quarantined_offsets(self) -> List[int]:
        with self._lock:
            return sorted(self._quarantined)

    # -- introspection --------------------------------------------------------
    def refcounts(self) -> Dict[int, int]:
        """offset -> refcount snapshot (the I6 checker's ground truth)."""
        with self._lock:
            return dict(self._refs)

    def unique_pages(self) -> int:
        with self._lock:
            return len(self._refs)

    def unique_bytes(self) -> int:
        """Physical tier bytes currently owned by the store."""
        return self.unique_pages() * PAGE_SIZE

    def logical_pages(self) -> int:
        """Sum of refcounts == pages the offset arrays believe are stored."""
        with self._lock:
            return sum(self._refs.values())

    def dedup_ratio(self) -> float:
        total = self.stats["unique"] + self.stats["dedup_hits"]
        return self.stats["dedup_hits"] / total if total else 0.0

    def report(self) -> Dict[str, float]:
        with self._lock:
            unique = len(self._refs)
            logical = sum(self._refs.values())
        return {
            "unique_pages": unique,
            "logical_pages": logical,
            "unique_bytes": unique * PAGE_SIZE,
            "logical_bytes": logical * PAGE_SIZE,
            "dedup_ratio": self.dedup_ratio(),
            **self.stats,
        }
