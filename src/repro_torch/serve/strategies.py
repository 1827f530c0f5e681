"""The paper's five restore configurations (§5.1.3), adapted to the same
two-tier pool so differences reflect algorithmic choices, not media:

  firecracker : full image in the RDMA pool; no prefetch; every touched page
                (including zero pages — they are stored in the full image)
                takes a fault → RDMA read → uffd.copy.
  reap        : prefetch the *recorded working set* (incl. its zero pages)
                via RDMA, rest demand-paged.
  faasnap     : prefetch only the non-zero working set via RDMA; zero-page
                faults resolve as minor faults (uffd.zeropage); cold pages
                demand-paged.
  fctiered    : Aquifer snapshot format (hot→CXL, cold→RDMA, zero sentinel)
                but no prefetch — pure demand paging over the tiers.
  aquifer     : hot set pre-installed from CXL before resume; zero faults →
                uffd.zeropage; cold faults → async RDMA (§3.4).

Each strategy returns **modeled** stage times: the device's wall time says
nothing about CXL/RDMA, so the model is the paper's cost constants in
core/pool.py plus a userfaultfd trap cost per major fault, with an optional
``scale`` that linearly extrapolates page counts to the paper's 1.5 GiB
instances.  The page classes come from the image on its device (the zero
scan is ``kernels/zero_detect``'s kernel on a CUDA image) and
:func:`verify_restore_correctness` moves real pages.  The numbers equal the
JAX package's for the same image, working set and calibration.

The per-page data-plane constants (``CHECKSUM_BW``, ``PUBLISH_SWEEP_PAGE_S``,
``PREINSTALL_PAGE_S``) come from a calibration file read at import,
``experiments/torch/kernel_calibration.json`` by default: the bytes the
port's kernels move per page over the H100's memory rate
(``scripts/write_calibration.py``).  The JAX package's file is a TPU v5e
roofline and is never loaded by default; :func:`load_calibration` reads any
file's constants.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

import torch

from ..core import HierarchicalPool, SnapshotReader, StateImage
from ..core.pagestore import PAGE_SIZE
from ..core.pool import (
    CLFLUSH_PER_LINE_S,
    UFFD_COPY_PER_PAGE_S,
    UFFD_ZEROPAGE_PER_PAGE_S,
    uffd_copy_batch_cost,
    uffd_zeropage_range_cost,
)
from ..core.serving import Instance, RestoreEngine

# keep the analytic model in lockstep with the measured serving path
HOT_CHUNK_PAGES = RestoreEngine.HOT_CHUNK_PAGES

FAULT_TRAP_S = 10e-6         # userfaultfd trap + handler wakeup + wake ioctl
SNAPSHOT_API_S = 1.5e-3      # Firecracker Snapshot API + uffd handshake
MACHINE_STATE_S = 1.0e-3     # load serialized vCPU/device state
CXL_LAT_S = 400e-9
CXL_BW = 50e9                # emulated CXL = remote NUMA node (§5.1.1)
RDMA_LAT_S = 3e-6
RDMA_BW = 100e9 / 8          # per-host RNIC, shared by co-located restores
CXL_PAGE_READ_S = CXL_LAT_S + PAGE_SIZE / CXL_BW
RDMA_PAGE_READ_S = RDMA_LAT_S + PAGE_SIZE / RDMA_BW
RDMA_INFLIGHT = 64
# Residual stall accounting for the predictive-prefetch A/B (DESIGN.md §17):
# a demand fault on an UNCOVERED cold page pays the trap plus the full
# synchronous RDMA page read plus the install; a fault that lands on a page
# whose prefetch is already in flight ("prefetch hit") pays only trap +
# install — the wire latency is (modeled as fully) hidden by the prefetcher.
DEMAND_FAULT_STALL_S = FAULT_TRAP_S + RDMA_PAGE_READ_S + UFFD_COPY_PER_PAGE_S
PREFETCH_HIT_STALL_S = FAULT_TRAP_S + UFFD_COPY_PER_PAGE_S
# Inter-pod fabric (topology layer, DESIGN.md §16): a read that leaves the
# host's CXL pod rides the RNIC through one extra switch hop.  Octopus-style
# pods are port-limited and sparse, so the fleet is many small pods and the
# inter-pod path is what a host pays when its pod holds no replica (or its
# pod's MHD ports are exhausted).  Bandwidth is the same 100 Gb/s RNIC; the
# hop adds fixed latency per op.
INTER_POD_HOP_S = 1.5e-6
INTER_POD_LAT_S = RDMA_LAT_S + INTER_POD_HOP_S
INTER_POD_BW = RDMA_BW
INTER_POD_INFLIGHT = RDMA_INFLIGHT


@dataclasses.dataclass
class RestoreResult:
    """Timing breakdown of one restore under a named strategy."""

    strategy: str
    setup_s: float               # machine state + snapshot API + prefetch
    prefetch_s: float
    exec_install_s: float        # page-installation time during execution
    compute_s: float
    stats: Dict[str, int]

    @property
    def total_s(self) -> float:
        return self.setup_s + self.exec_install_s + self.compute_s

    def breakdown(self) -> Dict[str, float]:
        return {
            "setup": self.setup_s - self.prefetch_s,
            "prefetch": self.prefetch_s,
            "exec_install": self.exec_install_s,
            "compute": self.compute_s,
            "total": self.total_s,
        }


@dataclasses.dataclass
class WorkloadSpec:
    """Everything a strategy needs about one serverless workload."""

    name: str
    image: StateImage                    # full state image (ground truth)
    working_set: np.ndarray              # profiled WS page indices (§3.2)
    touched: np.ndarray                  # pages touched by THIS invocation
    compute_s: float                     # function execution compute time
    scale: float = 1.0                   # page-count extrapolation factor


def residual_stall_s(n_demand_faults: int, n_prefetch_hits: int = 0) -> float:
    """Modeled guest-visible stall from cold-page faults during one
    invocation: uncovered faults pay the full demand shape, covered ones
    the hit shape.  The quantity the predicted-order prefetch policy is
    scored on (adaptive_bench phase-shift A/B)."""
    return (n_demand_faults * DEMAND_FAULT_STALL_S
            + n_prefetch_hits * PREFETCH_HIT_STALL_S)


def _shared(serial_s: float, nbytes: int, bw: float, conc: int) -> float:
    """Contention model: an instance is limited by its own serial path OR by
    its fair share of the host link, whichever is slower."""
    return max(serial_s, nbytes * conc / bw)


def _bulk_cc(conc: int) -> int:
    """Bulk prefetch happens in a short window right after dispatch; the
    load balancer staggers restores, so prefetch windows only partially
    overlap (~1/4 of co-located restores contend at once)."""
    return max(1, conc // 4)


def _rdma_bulk(n_pages: int, conc: int = 1) -> float:
    """Pipelined one-sided reads (QP depth RDMA_INFLIGHT); `conc` co-located
    restores share the RNIC bandwidth (latency is unaffected)."""
    if n_pages <= 0:
        return 0.0
    serial = -(-n_pages // RDMA_INFLIGHT) * RDMA_LAT_S + n_pages * PAGE_SIZE / RDMA_BW
    return _shared(serial, n_pages * PAGE_SIZE, RDMA_BW, _bulk_cc(conc))


def _rdma_pages_faulted(n_pages: int, conc: int = 1) -> float:
    """Synchronous per-fault reads: latency-serialized, bandwidth-floored."""
    serial = n_pages * (RDMA_LAT_S + PAGE_SIZE / RDMA_BW)
    return _shared(serial, n_pages * PAGE_SIZE, RDMA_BW, conc)


def _cxl_pages(n_pages: int, conc: int = 1) -> float:
    serial = n_pages * (CXL_LAT_S + PAGE_SIZE / CXL_BW)
    return _shared(serial, n_pages * PAGE_SIZE, CXL_BW, _bulk_cc(conc))


def _n_runs(pages) -> int:
    """``len(runs_from_pages(pages))``: the maximal runs of the page set,
    counted vectorized."""
    u = np.unique(np.asarray(pages, dtype=np.int64).reshape(-1))
    return int(1 + np.count_nonzero(np.diff(u) != 1)) if u.size else 0


def _classify(spec: WorkloadSpec):
    """Vectorized page classification: numpy boolean masks over the zero
    bitmap and a working-set membership mask, instead of Python set lookups
    per touched page.  Outputs are equivalent to the scalar reference: the
    ``t_*`` arrays preserve ``spec.touched`` order (duplicates included),
    the ``ws_*`` arrays are the deduplicated working set in sorted order."""
    zero = spec.image.zero_page_bitmap()
    ws_idx = (np.unique(np.asarray(spec.working_set, dtype=np.int64))
              if len(spec.working_set) else np.zeros(0, dtype=np.int64))
    ws_mask = np.zeros(zero.size, dtype=bool)
    ws_mask[ws_idx] = True
    touched = np.asarray(spec.touched, dtype=np.int64).reshape(-1)
    t_is_zero = zero[touched]
    t_in_ws = ws_mask[touched]
    t_zero = touched[t_is_zero]
    t_hot = touched[~t_is_zero & t_in_ws]
    t_cold = touched[~t_is_zero & ~t_in_ws]
    ws_zero = ws_idx[zero[ws_idx]]
    ws_nonzero = ws_idx[~zero[ws_idx]]
    return zero, t_zero, t_hot, t_cold, ws_zero, ws_nonzero


def _cxl_chunks(n_pages: int, conc: int = 1) -> float:
    """Streamed CXL reads over the *compacted* hot region: one op-latency per
    HOT_CHUNK_PAGES chunk (never worse than one per run); the per-host link
    bandwidth floor is physics and stays."""
    n_ops = -(-n_pages // HOT_CHUNK_PAGES) if n_pages else 0
    serial = n_ops * CXL_LAT_S + n_pages * PAGE_SIZE / CXL_BW
    return _shared(serial, n_pages * PAGE_SIZE, CXL_BW, _bulk_cc(conc))


def run_strategy(strategy: str, spec: WorkloadSpec, concurrency: int = 1,
                 batched: bool = True) -> RestoreResult:
    """`concurrency` co-located restores share the host's CXL link and RNIC
    bandwidth; per-op latencies and CPU-side uffd costs are per-instance.

    ``batched=True`` (default) models run-coalesced installs for the
    prefetch-style strategies: prefetched pages land run-at-a-time (one
    uffd.copy ioctl per contiguous run), and Aquifer's hot pre-install pays
    one CXL op-latency per run instead of per page.  ``batched=False`` keeps
    the strictly page-at-a-time model for comparison."""
    zero, t_zero, t_hot, t_cold, ws_zero, ws_nonzero = _classify(spec)
    sc = spec.scale
    cc = max(1, concurrency)
    ws_runs = _n_runs(spec.working_set)
    hot_runs = _n_runs(ws_nonzero)
    t_cold_runs = _n_runs(t_cold)
    stats = {
        "touched": len(spec.touched), "t_zero": len(t_zero),
        "t_hot": len(t_hot), "t_cold": len(t_cold),
        "ws": len(spec.working_set),
        "ws_runs": ws_runs, "hot_runs": hot_runs,
    }
    setup = SNAPSHOT_API_S + MACHINE_STATE_S
    prefetch = 0.0
    exec_install = 0.0

    n = lambda k: int(k * sc)  # page counts extrapolated to paper-size instances
    # run counts scale with page counts (mean run length is size-invariant)

    def install_cost(n_pages: int, n_runs: int) -> float:
        """uffd.copy install of a prefetched set: batched = one ioctl per
        contiguous run; per-page = one ioctl per page."""
        if batched:
            return uffd_copy_batch_cost(n_pages, max(1, n_runs)) if n_pages else 0.0
        return n_pages * UFFD_COPY_PER_PAGE_S

    if strategy == "firecracker":
        # all touched pages: major fault + sync RDMA read + uffd.copy
        nt = n(len(spec.touched))
        exec_install = (
            nt * (FAULT_TRAP_S + UFFD_COPY_PER_PAGE_S) + _rdma_pages_faulted(nt, cc)
        )
    elif strategy == "reap":
        n_pre = n(len(spec.working_set))
        prefetch = _rdma_bulk(n_pre, cc) + install_cost(n_pre, n(ws_runs))
        nc_ = n(len(t_cold))
        exec_install = nc_ * (FAULT_TRAP_S + UFFD_COPY_PER_PAGE_S) + _rdma_pages_faulted(nc_, cc)
    elif strategy == "faasnap":
        n_pre = n(len(ws_nonzero))
        prefetch = _rdma_bulk(n_pre, cc) + install_cost(n_pre, n(hot_runs))
        nz, nc_ = n(len(t_zero)), n(len(t_cold))
        exec_install = (
            nz * (FAULT_TRAP_S + UFFD_ZEROPAGE_PER_PAGE_S)
            + nc_ * (FAULT_TRAP_S + UFFD_COPY_PER_PAGE_S) + _rdma_pages_faulted(nc_, cc)
        )
    elif strategy == "fctiered":
        # Aquifer format, no prefetch: hot faults serve from CXL
        nh, nz, nc_ = n(len(t_hot)), n(len(t_zero)), n(len(t_cold))
        exec_install = (
            nh * (FAULT_TRAP_S + UFFD_COPY_PER_PAGE_S) + _cxl_pages(nh, cc)
            + nz * (FAULT_TRAP_S + UFFD_ZEROPAGE_PER_PAGE_S)
            + nc_ * (FAULT_TRAP_S + UFFD_COPY_PER_PAGE_S) + _rdma_pages_faulted(nc_, cc)
        )
    elif strategy == "aquifer":
        n_hot, n_hruns = n(len(ws_nonzero)), n(hot_runs)
        # serialized CXL pre-install (§5.2) + clflush of the CXL sections
        flush = (n_hot * PAGE_SIZE / 64) * CLFLUSH_PER_LINE_S
        if batched:
            # run-coalesced: chunked CXL reads over the compact hot region,
            # one uffd.copy ioctl per guest-contiguous run
            prefetch = _cxl_chunks(n_hot, cc) + install_cost(n_hot, n_hruns) + flush
        else:
            prefetch = _cxl_pages(n_hot, cc) + n_hot * UFFD_COPY_PER_PAGE_S + flush
        # cold faults overlap via async RDMA: latency hidden up to QP depth;
        # the completion handler installs extent-at-a-time when batched
        nz, nc_ = n(len(t_zero)), n(len(t_cold))
        async_cold = (_rdma_bulk(nc_, cc) + nc_ * FAULT_TRAP_S
                      + install_cost(nc_, n(t_cold_runs)))
        exec_install = nz * (FAULT_TRAP_S + UFFD_ZEROPAGE_PER_PAGE_S) + async_cold
    else:
        raise ValueError(strategy)

    return RestoreResult(
        strategy=strategy,
        setup_s=setup + prefetch,
        prefetch_s=prefetch,
        exec_install_s=exec_install,
        compute_s=spec.compute_s,
        stats=stats,
    )


STRATEGIES = ("firecracker", "reap", "faasnap", "fctiered", "aquifer")


def hot_preinstall_time(spec: WorkloadSpec, batched: bool = True) -> float:
    """Modeled hot pre-install time (CXL reads + uffd installs) for one
    instance, excluding the borrow-protocol clflush (which the Orchestrator
    pays before pre-install) and link contention.  This is the per-run vs
    per-page comparison the run-coalesced serving design targets."""
    _zero, _tz, _th, _tc, _wsz, hot = _classify(spec)
    n_hot = int(len(hot) * spec.scale)
    if not batched:
        return n_hot * (CXL_LAT_S + PAGE_SIZE / CXL_BW) + n_hot * UFFD_COPY_PER_PAGE_S
    n_runs = int(_n_runs(hot) * spec.scale)
    n_chunks = -(-n_hot // HOT_CHUNK_PAGES) if n_hot else 0
    read = n_chunks * CXL_LAT_S + n_hot * PAGE_SIZE / CXL_BW
    return read + uffd_copy_batch_cost(n_hot, max(1, n_runs))


def modeled_concurrent_restore_s(reader, conc: int, max_extent_pages: int = 64,
                                 chunk_pages: Optional[int] = None) -> float:
    """Analytic modeled time of ONE full restore — machine-state + index
    reads, borrow clflush, chunked hot pre-install, zero ranges, and a
    doorbell-batched cold-extent prefetch that covers every cold page (no
    demand faults) — while `conc` independent streams contend for the
    host's CXL link and RNIC.

    Every transfer term is `_shared()` over the same run/extent arithmetic
    the serving path executes, so this is the analytic twin of the executed
    path's per-host ``LinkArbiter`` accounting: the property tests require
    the two to agree within 15% across random concurrency/workload mixes.
    For fan-out groups (k same-snapshot restores through a NodePageServer)
    pass the number of distinct *groups* as `conc` — the link carries each
    group's bytes once regardless of k.
    """
    r = reader.regions
    chunk = chunk_pages or HOT_CHUNK_PAGES
    conc = max(1, conc)
    # machine state + offset array (one HostView read each), cold index if
    # the cold tier is compressed
    t = _shared(CXL_LAT_S + r.ms_size / CXL_BW, r.ms_size, CXL_BW, conc)
    oa_bytes = r.total_pages * 8
    t += _shared(CXL_LAT_S + oa_bytes / CXL_BW, oa_bytes, CXL_BW, conc)
    if r.cold_compressed and r.n_cold:
        ci_bytes = r.n_cold * 4
        t += _shared(CXL_LAT_S + ci_bytes / CXL_BW, ci_bytes, CXL_BW, conc)
    # borrow-protocol clflushopt over the snapshot's CXL sections
    n_lines = -(-(r.ms_size + r.oa_size + max(r.hot_bytes, 0)) // 64)
    t += n_lines * CLFLUSH_PER_LINE_S
    # hot pre-install: one CXL read per extent (contiguous-region chunk, or
    # adjacent-store-offset run for dedup), one uffd.copy ioctl per
    # guest-contiguous run within each extent — the same extent walk the
    # serving path executes (reader.iter_hot_extents)
    n_hot, n_chunks, n_ranges = 0, 0, 0
    for pages, _off, _nbytes in reader.iter_hot_extents(chunk):
        n_chunks += 1
        n_hot += int(pages.size)
        seg = np.sort(pages)
        n_ranges += 1 + int(np.count_nonzero(np.diff(seg) != 1))
    if n_hot:
        t += _shared(n_chunks * CXL_LAT_S + n_hot * PAGE_SIZE / CXL_BW,
                     n_hot * PAGE_SIZE, CXL_BW, conc)
        t += uffd_copy_batch_cost(n_hot, n_ranges)
    # zero pages: one uffd.zeropage ioctl per zero run
    zr = reader.zero_runs()
    if zr.size:
        t += uffd_zeropage_range_cost(int(zr[:, 1].sum()), int(zr.shape[0]))
    # cold prefetch: pipelined extent reads (QP-depth doorbell batching),
    # one uffd.copy ioctl per extent install
    cr = reader.cold_runs()
    n_cold = int(cr[:, 1].sum()) if cr.size else 0
    if n_cold:
        n_ext, cold_bytes = 0, 0
        for _es, _en, _rank0, _off, nbytes in reader.iter_cold_extents(
                max_extent_pages):
            cold_bytes += nbytes
            n_ext += 1
        serial = -(-n_ext // RDMA_INFLIGHT) * RDMA_LAT_S + cold_bytes / RDMA_BW
        t += _shared(serial, cold_bytes, RDMA_BW, conc)
        t += uffd_copy_batch_cost(n_cold, n_ext)
    return t


def modeled_degraded_restore_s(reader, conc: int = 1,
                               max_extent_pages: int = 64) -> float:
    """Analytic modeled time of one restore while the CXL host link is
    browned out (DESIGN.md §15): the breaker is open, so EVERY byte that
    would have crossed the CXL link — machine state, offset array, cold
    index, and the whole hot set — is fetched over the RDMA fabric instead,
    at the RDMA demand shape.  This is the analytic twin of the executed
    degraded path (``SnapshotReader.degraded_cxl_read`` +
    ``RestoreEngine.drain_degraded_hot``): metadata reads become single RDMA
    transfers, hot pages demand-fault one page per transfer (the all-cold
    fault shape of :func:`_rdma_pages_faulted`) with one uffd.copy each, and
    the zero/cold terms are unchanged from
    :func:`modeled_concurrent_restore_s`."""
    r = reader.regions
    conc = max(1, conc)
    # metadata over RDMA: one transfer each, no CXL op latency
    t = _shared(RDMA_LAT_S + r.ms_size / RDMA_BW, r.ms_size, RDMA_BW, conc)
    oa_bytes = r.total_pages * 8
    t += _shared(RDMA_LAT_S + oa_bytes / RDMA_BW, oa_bytes, RDMA_BW, conc)
    if r.cold_compressed and r.n_cold:
        ci_bytes = r.n_cold * 4
        t += _shared(RDMA_LAT_S + ci_bytes / RDMA_BW, ci_bytes, RDMA_BW, conc)
    # the borrow protocol still clflushes the snapshot's CXL sections — the
    # flush is owner-coherence work, not a host-link read
    n_lines = -(-(r.ms_size + r.oa_size + max(r.hot_bytes, 0)) // 64)
    t += n_lines * CLFLUSH_PER_LINE_S
    # hot set: page-granular demand faults over RDMA (the pre-install was
    # skipped), one uffd.copy ioctl per page
    n_hot = int(reader.hot_page_indices().size)
    if n_hot:
        t += _rdma_pages_faulted(n_hot, conc)
        t += uffd_copy_batch_cost(n_hot, n_hot)
    # zero pages: one uffd.zeropage ioctl per zero run (unchanged)
    zr = reader.zero_runs()
    if zr.size:
        t += uffd_zeropage_range_cost(int(zr[:, 1].sum()), int(zr.shape[0]))
    # cold prefetch: identical to the healthy path (it never touched CXL)
    cr = reader.cold_runs()
    n_cold = int(cr[:, 1].sum()) if cr.size else 0
    if n_cold:
        n_ext, cold_bytes = 0, 0
        for _es, _en, _rank0, _off, nbytes in reader.iter_cold_extents(
                max_extent_pages):
            cold_bytes += nbytes
            n_ext += 1
        serial = -(-n_ext // RDMA_INFLIGHT) * RDMA_LAT_S + cold_bytes / RDMA_BW
        t += _shared(serial, cold_bytes, RDMA_BW, conc)
        t += uffd_copy_batch_cost(n_cold, n_ext)
    return t


# -- content-addressed (dedup) publish/restore economics ---------------------
# Hashing throughput of the publish-time content hash, and the fused data
# plane's per-page sweep times: the fused publish computes the hash in the
# same pass that streams the page, so each is one streaming pass at the
# card's memory rate.  The values come from a committed calibration file
# read at import, never re-measured, so modeled numbers stay deterministic
# per commit; the hand-set defaults below apply only when the file is absent.
CALIBRATION_PATH = (Path(__file__).resolve().parents[3]
                    / "experiments" / "torch" / "kernel_calibration.json")
_CALIBRATION_DEFAULTS = {
    "checksum_bw_Bps": 20e9,              # pre-calibration hand-set value
    "publish_sweep_page_s": 2 * PAGE_SIZE / 20e9,
    "preinstall_page_s": 2 * PAGE_SIZE / 20e9,
}


def load_calibration(path=None) -> Dict[str, float]:
    """The calibration constants of ``path`` (default
    :data:`CALIBRATION_PATH`); a missing file, a missing key or an
    unreadable file leaves the hand-set default."""
    try:
        cal = json.loads(Path(path or CALIBRATION_PATH).read_text())
        consts = cal.get("constants", {})
    except (OSError, ValueError):
        consts = {}
    return {k: float(consts.get(k, v)) for k, v in _CALIBRATION_DEFAULTS.items()}


CALIBRATION = load_calibration()
CHECKSUM_BW = CALIBRATION["checksum_bw_Bps"]
CHECKSUM_PER_PAGE_S = PAGE_SIZE / CHECKSUM_BW
# fused data-plane per-page sweep times ("and friends"): publish = one-pass
# zero-scan + checksum + compaction; pre-install = gather + verify + scatter.
# No cost model reads these two yet, here or in the JAX package: they keep
# the JAX package's names and calibration keys.
PUBLISH_SWEEP_PAGE_S = CALIBRATION["publish_sweep_page_s"]
PREINSTALL_PAGE_S = CALIBRATION["preinstall_page_s"]


def dedup_publish_cost_s(n_hot: int, n_cold: int,
                         n_hot_unique: int, n_cold_unique: int) -> float:
    """Modeled owner-side publish cost WITH dedup: every candidate page is
    hashed (and byte-verified on a hash hit — same streaming pass), but only
    the UNIQUE pages cross a link into their tier."""
    hash_s = (n_hot + n_cold) * CHECKSUM_PER_PAGE_S
    return hash_s + _cxl_chunks(n_hot_unique) + _rdma_bulk(n_cold_unique)


def baseline_publish_cost_s(n_hot: int, n_cold: int) -> float:
    """Modeled owner-side publish cost WITHOUT dedup: every page is written."""
    return _cxl_chunks(n_hot) + _rdma_bulk(n_cold)


def dedup_restore_penalty_s(n_extra_hot_extents: int,
                            n_extra_cold_extents: int) -> float:
    """Per-restore cost of dedup's lost contiguity: each extra CXL extent
    pays one more load-to-use latency, each extra RDMA extent one more
    one-sided-read latency (bandwidth terms are unchanged — the same bytes
    move; uffd ranges are guest-side and also unchanged)."""
    return (max(0, n_extra_hot_extents) * CXL_LAT_S
            + max(0, n_extra_cold_extents) * RDMA_LAT_S)


def dedup_economics(n_hot: int, n_cold: int,
                    n_hot_unique: int, n_cold_unique: int,
                    n_extra_hot_extents: int = 0,
                    n_extra_cold_extents: int = 0,
                    expected_restores: int = 64) -> Dict[str, float]:
    """Break-even model for content-addressed publishing of one snapshot.

    Dedup is a CAPACITY play: every shared hot page keeps one page of CXL
    free, which lets another snapshot's hot set stay resident instead of
    degrading to RDMA demand paging.  The benefit side therefore prices each
    saved CXL page at the demand-fault path it spares some co-resident
    restore (trap + synchronous-feeling RDMA read + per-page uffd.copy,
    minus the pre-install path the page rides instead) — the same arithmetic
    :func:`recuration_benefit_s` uses for promotions.  The cost side is the
    publish-time hashing overhead plus the per-restore fragmentation
    penalty, both amortized over ``expected_restores``.
    """
    pages_saved_cxl = max(0, n_hot - n_hot_unique)
    saved_demand = pages_saved_cxl * (FAULT_TRAP_S + RDMA_PAGE_READ_S
                                      + UFFD_COPY_PER_PAGE_S)
    saved_preinstall = (_cxl_chunks(pages_saved_cxl)
                        + uffd_copy_batch_cost(pages_saved_cxl)
                        if pages_saved_cxl else 0.0)
    benefit_s = (saved_demand - saved_preinstall) * expected_restores
    publish_delta_s = (dedup_publish_cost_s(n_hot, n_cold,
                                            n_hot_unique, n_cold_unique)
                       - baseline_publish_cost_s(n_hot, n_cold))
    penalty_s = dedup_restore_penalty_s(n_extra_hot_extents,
                                        n_extra_cold_extents)
    cost_s = max(0.0, publish_delta_s) + penalty_s * expected_restores
    return {
        "pages_saved_cxl": float(pages_saved_cxl),
        "bytes_saved": float((n_hot - n_hot_unique + n_cold - n_cold_unique)
                             * PAGE_SIZE),
        "benefit_s": benefit_s,
        "publish_delta_s": publish_delta_s,
        "restore_penalty_s": penalty_s,
        "cost_s": cost_s,
        "net_s": benefit_s - cost_s,
        "expected_restores": float(expected_restores),
        "worthwhile": bool(benefit_s > cost_s),
    }


# -- keep-warm vs re-restore economics (fleet serving layer) ------------------
# Reactivating a kept-warm instance moves no pages: it is a scheduler wake +
# cgroup unfreeze, modeled as a fixed resume cost.
WARM_RESUME_S = 0.5e-3
# Holding an instance warm pins its resident bytes on the host.  The
# opportunity cost is what the pod could do with those bytes instead: keep
# another snapshot's hot page resident and spare its next restore the
# demand-fault path (trap + synchronous-feeling RDMA read + per-page
# uffd.copy), amortized over a typical inter-restore interval of the
# displaced snapshot.  Same price base as recuration_benefit_s.
KEEPWARM_DISPLACE_INTERVAL_S = 1.0
KEEPWARM_BYTE_S_COST = ((FAULT_TRAP_S + RDMA_PAGE_READ_S + UFFD_COPY_PER_PAGE_S)
                        / (PAGE_SIZE * KEEPWARM_DISPLACE_INTERVAL_S))


def keepwarm_economics(restore_s: float, expected_gap_s: float,
                       resident_bytes: int) -> Dict[str, float]:
    """Break-even model for holding a just-finished instance warm until its
    function's next expected arrival (``expected_gap_s`` away) instead of
    releasing it and paying a cold restore then.

    Benefit: the next invocation skips the restore (pays ``WARM_RESUME_S``).
    Cost: ``resident_bytes`` pinned for the gap, priced at the memory's
    opportunity cost (:data:`KEEPWARM_BYTE_S_COST`).  The fleet driver keeps
    an instance warm exactly when this verdict says so, and holds it for at
    most the expected gap — an instance whose function went quiet is
    reclaimed at expiry, Azure-Functions keep-alive style.
    """
    benefit_s = max(0.0, restore_s - WARM_RESUME_S)
    hold_cost_s = expected_gap_s * resident_bytes * KEEPWARM_BYTE_S_COST
    rate = resident_bytes * KEEPWARM_BYTE_S_COST
    return {
        "benefit_s": benefit_s,
        "hold_cost_s": hold_cost_s,
        "net_s": benefit_s - hold_cost_s,
        "break_even_gap_s": benefit_s / rate if rate > 0 else float("inf"),
        "worthwhile": bool(benefit_s > hold_cost_s),
    }


def recuration_benefit_s(n_promote: int, n_demote: int,
                         expected_restores: int = 64) -> float:
    """Modeled seconds saved over ``expected_restores`` future restores if
    ``n_promote`` hot-faulting cold pages move into the CXL hot region and
    ``n_demote`` never-touched hot pages move out to RDMA.

    Per restore:

    * each promoted page stops paying the demand-fault path
      (trap + synchronous-feeling RDMA read + per-page uffd.copy) and
      instead rides the chunked CXL pre-install (amortized op latency +
      bandwidth + its share of a batched uffd.copy);
    * each demoted page stops being pre-installed at all (it was never
      touched, so it costs nothing after demotion).
    """
    if expected_restores <= 0:
        return 0.0
    promote_now = n_promote * (FAULT_TRAP_S + RDMA_PAGE_READ_S
                               + UFFD_COPY_PER_PAGE_S)
    promote_after = (_cxl_chunks(n_promote) + uffd_copy_batch_cost(n_promote)
                     if n_promote else 0.0)
    demote_saved = ((_cxl_chunks(n_demote) + uffd_copy_batch_cost(n_demote))
                    if n_demote else 0.0)
    per_restore = (promote_now - promote_after) + demote_saved
    return per_restore * expected_restores


def recuration_cost_s(regions) -> float:
    """Modeled cost of one re-curation rebuild: the owner materializes the
    full image (hot region streamed from CXL, cold region bulk-read from
    RDMA), rewrites both data regions, and republishes through the
    ownership protocol (tombstone + drain + catalog writes ~ one RDMA RPC
    budget).  Zero pages are free in both directions."""
    hot_pages = regions.n_hot
    cold_pages = regions.n_cold
    cold_payload = (regions.cold_bytes if regions.cold_compressed
                    else cold_pages * PAGE_SIZE)
    read = _cxl_chunks(hot_pages) + _shared(
        -(-cold_pages // RDMA_INFLIGHT) * RDMA_LAT_S
        + cold_payload / RDMA_BW, cold_payload, RDMA_BW, 1)
    # rewrite: every non-zero page crosses a link once more (hot→CXL write,
    # cold→RDMA write; promoted/demoted pages just swap which link)
    write = _cxl_chunks(hot_pages) + _shared(
        -(-cold_pages // RDMA_INFLIGHT) * RDMA_LAT_S
        + cold_payload / RDMA_BW, cold_payload, RDMA_BW, 1)
    return read + write + SNAPSHOT_API_S


def recuration_economics(regions, plan, expected_restores: int = 64) -> Dict[str, float]:
    """Break-even model gating re-curation (the analytic twin the
    ``PoolMaster.recurate`` pipeline consults): rebuild only when the
    modeled fault-latency savings over the snapshot's expected remaining
    restores exceed the modeled rebuild cost."""
    benefit = recuration_benefit_s(int(plan.promote.size), int(plan.demote.size),
                                   expected_restores)
    cost = recuration_cost_s(regions)
    return {
        "benefit_s": benefit,
        "cost_s": cost,
        "net_s": benefit - cost,
        "expected_restores": float(expected_restores),
        "worthwhile": bool(benefit > cost),
    }


def interpod_bulk_read_s(n_pages: int, conc: int = 1) -> float:
    """Pipelined one-sided reads over the inter-pod fabric (RNIC + one
    switch hop): the chunked hot pre-install repriced for a replica that
    lives in another pod.  ``conc`` distinct streams share the RNIC."""
    if n_pages <= 0:
        return 0.0
    serial = (-(-n_pages // INTER_POD_INFLIGHT) * INTER_POD_LAT_S
              + n_pages * PAGE_SIZE / INTER_POD_BW)
    return _shared(serial, n_pages * PAGE_SIZE, INTER_POD_BW, conc)


def interpod_hot_penalty_s(n_hot_pages: int, conc: int = 1) -> float:
    """Extra modeled seconds a restore pays when its hot set must cross the
    inter-pod fabric instead of the local pod's CXL link — the surcharge the
    pod-aware placement score applies to hosts whose pod holds no replica
    (replica distance 1) or whose MHD ports are exhausted (attach
    fallthrough).  Never negative: CXL is the faster path by construction."""
    if n_hot_pages <= 0:
        return 0.0
    return max(0.0, interpod_bulk_read_s(n_hot_pages, conc)
               - _cxl_chunks(n_hot_pages, conc))


def migration_economics(hot_bytes: int, cold_bytes: int,
                        expected_reads: int, conc: int = 1) -> Dict[str, float]:
    """Break-even model gating snapshot replication/migration toward demand
    (the analytic twin ``topology.MigrationManager`` consults).

    Benefit: each of the next ``expected_reads`` restores from the demanding
    pod stops paying the inter-pod hot penalty and reads intra-pod CXL.
    Cost: the snapshot's payload crosses the inter-pod fabric once (hot +
    cold), is rewritten into the target pod's tiers, and republishes through
    the ownership protocol (~ one snapshot-API budget) — the same shape as
    :func:`recuration_cost_s` with the read side repriced inter-pod."""
    n_hot = int(hot_bytes) // PAGE_SIZE
    n_cold = int(cold_bytes) // PAGE_SIZE
    per_read = interpod_hot_penalty_s(n_hot, conc)
    benefit = per_read * max(0, int(expected_reads))
    copy_read = interpod_bulk_read_s(n_hot + n_cold)
    copy_write = _cxl_chunks(n_hot) + _rdma_bulk(n_cold)
    cost = copy_read + copy_write + SNAPSHOT_API_S
    return {
        "benefit_s": benefit,
        "cost_s": cost,
        "net_s": benefit - cost,
        "per_read_saving_s": per_read,
        "break_even_reads": (cost / per_read if per_read > 0
                             else float("inf")),
        "worthwhile": bool(benefit > cost),
    }


def verify_restore_correctness(pool: HierarchicalPool, reader: SnapshotReader,
                               spec: WorkloadSpec) -> bool:
    """Real-data check: a full Aquifer restore reproduces the image bits."""
    inst = Instance(StateImage.empty_like(spec.image.manifest, device=spec.image.device))
    eng = RestoreEngine(reader, inst, rdma_engine=None)
    eng.pre_install_hot()
    eng.install_all_sync()
    return bool(torch.equal(inst.image.buf, spec.image.buf))
