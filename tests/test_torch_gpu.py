"""On the card: each CUDA kernel of the port against its plain torch version,
the publish→restore slice and a reduced dense model at a small size.  Marked ``gpu``; they skip
where there is no card.  This file imports no JAX, so it runs on a machine
with PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.kernels import (
    ChecksumMismatchError,
    FusedScatter,
    fused_publish,
    fused_restore,
    fused_restore_rows,
    page_checksum,
    page_gather,
    page_scatter,
    page_scatter_rows,
    zero_detect,
)
from repro_torch.kernels.page_checksum.ops import weights_on
from repro_torch.kernels.page_checksum.ref import page_checksum_ref
from repro_torch.kernels.page_gather.ref import page_gather_ref
from repro_torch.kernels.page_scatter.ref import page_scatter_ref, page_scatter_rows_ref
from repro_torch.kernels.snapshot_fuse import kernel as snapshot_kernel
from repro_torch.kernels.snapshot_fuse.ops import PUBLISH_TILE_PAGES, publish_rows
from repro_torch.kernels.snapshot_fuse.ref import (
    fused_publish_ref,
    fused_restore_ref,
    fused_restore_rows_ref,
)
from repro_torch.kernels.zero_detect.ref import zero_detect_ref

PAGE = 4096
T = PUBLISH_TILE_PAGES
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pages(n, seed, zero_every):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 256, size=(n, PAGE), dtype=np.uint8)
    if zero_every:
        pages[::zero_every] = 0
    if zero_every == 3:
        pages[1::7] = 0xFF                    # all-ones lanes: the wrap case
    return pages, rng.random(n) < 0.4


def _publish_inputs(n, seed, zero_every, ws_kind, device):
    """Pages (every ``zero_every``-th one zero, every 7th from 1 all 0xFF when
    it is 3) and a working set (``rand``: 40%, ``all``, ``none``), made on
    the card from ``seed``: the largest cases are gigabytes."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pages = torch.randint(0, 256, (n, PAGE), dtype=torch.uint8, generator=g, device=device)
    if zero_every:
        pages[::zero_every] = 0
    if zero_every == 3:
        pages[1::7] = 0xFF                    # all-ones lanes: the wrap case
    ws = {"rand": lambda: torch.rand(n, generator=g, device=device) < 0.4,
          "all": lambda: torch.ones(n, dtype=torch.bool, device=device),
          "none": lambda: torch.zeros(n, dtype=torch.bool, device=device)}[ws_kind]()
    return pages, ws


def _assert_publish_matches_plain(got, pages, ws):
    for a, b in zip((got.zero_bitmap, got.checksums, got.hot, got.cold),
                    fused_publish_ref(pages, ws)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n,zero_every,ws_kind", [
    (0, 3, "rand"), (1, 0, "rand"), (37, 3, "rand"), (1000, 3, "rand"),
    (T - 1, 3, "rand"), (T, 3, "rand"), (T + 1, 3, "rand"), (3 * T + 5, 3, "rand"),
    (64, 1, "rand"),                          # all zero
    (64, 0, "rand"), (3 * T + 5, 3, "all"), (64, 0, "all"), (64, 0, "none"),
    (393_216, 3, "rand"),                     # the 1.5 GiB image's page count
    (600_000, 3, "rand"),                     # rows past 2^31 bytes, in and out
])
def test_publish_kernel_matches_plain(cuda_device, n, zero_every, ws_kind):
    p, w = _publish_inputs(n, n + 1, zero_every, ws_kind, cuda_device)
    before = fused_publish.launches
    got = fused_publish(p, w)
    torch.cuda.synchronize()
    _assert_publish_matches_plain(got, p, w)
    assert fused_publish.launches == before + (1 if n else 0)
    if n:   # the kept columns never pin the page buffer
        rows = got.hot.untyped_storage().data_ptr()
        assert got.cold.untyped_storage().data_ptr() == rows
        for col in (got.checksums, got.zero_bitmap):
            assert col.untyped_storage().data_ptr() != rows


def test_publish_kernel_back_to_back_launches(cuda_device):
    """50 launches queued on one stream with no sync between them, sharing
    one status scratch and alternating two images of other sizes and
    contents, each into outputs of its own: no tile status or tile count
    carries over from the launch before."""
    images = [_publish_inputs(5 * T * 100 + 3, 7, 3, "rand", cuda_device),
              _publish_inputs(4 * T * 100 + 1, 8, 2, "all", cuda_device)]
    wants = [fused_publish_ref(*im) for im in images]
    weights = weights_on(cuda_device, PAGE // 4)
    scratch = torch.empty(1 + -(-images[0][0].shape[0] // T), dtype=torch.int64,
                          device=cuda_device)
    outs = []
    for i in range(50):
        pages, ws = images[i % 2]
        n, n_ws = pages.shape[0], int(ws.sum())
        out = (torch.empty(n, dtype=torch.bool, device=cuda_device),
               torch.empty(n, dtype=torch.int32, device=cuda_device),
               torch.empty_like(pages), torch.empty(2, dtype=torch.int32, device=cuda_device))
        outs.append((n_ws, out))
    for i, (n_ws, (zero, csum, buf, counts)) in enumerate(outs):
        pages, ws = images[i % 2]
        snapshot_kernel.publish(pages, ws, weights, n_ws, T, zero, csum, buf, counts, scratch)
    torch.cuda.synchronize()
    for i, (n_ws, (zero, csum, buf, counts)) in enumerate(outs):
        n_hot, n_cold = counts.tolist()
        got = (zero, csum, *publish_rows(buf, n_ws, n_hot, n_cold))
        for a, b in zip(got, wants[i % 2]):
            assert a.dtype == b.dtype and torch.equal(a, b), f"launch {i}"


@pytest.mark.parametrize("m", [1, 37, 256])
def test_restore_kernel_matches_plain_and_verifies(cuda_device, m):
    rng = np.random.default_rng(m)
    chunk = torch.from_numpy(rng.integers(0, 256, (m, PAGE), dtype=np.uint8)).to(cuda_device)
    dst = np.sort(rng.choice(4096, m, replace=False))
    src = rng.permutation(m)
    dest_k = torch.zeros((4096, PAGE), dtype=torch.uint8, device=cuda_device)
    dest_p = dest_k.clone()
    _, cs = fused_restore(dest_k, chunk, dst, src_indices=src)
    want = fused_restore_ref(dest_p, chunk, torch.from_numpy(src).to(cuda_device),
                             torch.from_numpy(dst).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(dest_k, dest_p) and torch.equal(cs, want)
    table = torch.zeros(4096, dtype=torch.int32, device=cuda_device)
    table[torch.from_numpy(dst).to(cuda_device)] = want
    fused_restore(dest_k, chunk, dst, src_indices=src, expected_table=table)
    table[int(dst[-1])] ^= 1
    with pytest.raises(ChecksumMismatchError) as ei:
        fused_restore(dest_k, chunk, dst, src_indices=src, expected_table=table)
    assert ei.value.bad_pages.tolist() == [int(dst[-1])]


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    bad = torch.zeros((4, 100), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        fused_publish(bad, torch.zeros(4, dtype=torch.bool, device=cuda_device))
    dest = torch.zeros((8, PAGE), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(IndexError):
        fused_restore(dest, dest[:2].clone(), np.array([0, 8]))


def test_slice_publish_restore_small(cuda_device):
    """The main path at 2048 pages on the card: bit-identical, every page
    verified, launch counts as the layout predicts."""
    rng = np.random.default_rng(0)
    n = 2048
    pages = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    pages[rng.random(n) < 0.6] = 0
    hot = np.flatnonzero(rng.random(n) < 0.1)
    manifest = core.Manifest([core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    image = core.StateImage(manifest, torch.from_numpy(pages.reshape(-1)).to(cuda_device))
    pool = core.HierarchicalPool(16 << 20, 16 << 20, device=cuda_device)
    fused_publish.launches = fused_restore.launches = 0
    from repro_torch.kernels import make_fused_publish_fn

    regions = core.build_snapshot(pool, image, hot, "g", publish_fn=make_fused_publish_fn())
    ledger = core.TimeLedger()
    reader = core.SnapshotReader(regions, pool.host_view("h", ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = core.Instance(core.StateImage.empty_like(manifest, device=cuda_device), ledger)
    eng = core.RestoreEngine(reader, inst, scatter_fn=FusedScatter())
    eng.pre_install_hot(chunk_pages=64)
    eng.install_all_sync()
    torch.cuda.synchronize()
    assert torch.equal(inst.image.buf, image.buf)
    assert inst.scatter_fn.stats["pages_verified"] == regions.n_hot + regions.n_cold
    assert fused_publish.launches == 1
    # two batched walks (hot, cold), each a verify-only launch and an install
    assert eng.walk_routes["batched"] == 2
    assert fused_restore.launches == 4
    back = core.reconstruct_image(pool, regions)
    assert torch.equal(back.buf, image.buf)


def test_demand_faults_and_prefetch_threads_on_card(cuda_device):
    """The completion and prefetch threads install through the kernel on
    the card; every buffer comes back and every thread is joined."""
    rng = np.random.default_rng(1)
    n = 1024
    pages = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    pages[rng.random(n) < 0.5] = 0
    manifest = core.Manifest([core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    image = core.StateImage(manifest, torch.from_numpy(pages.reshape(-1)).to(cuda_device))
    pool = core.HierarchicalPool(8 << 20, 8 << 20, device=cuda_device)
    from repro_torch.kernels import make_fused_publish_fn

    regions = core.build_snapshot(pool, image, np.arange(0, n, 9), "d",
                                  publish_fn=make_fused_publish_fn())
    ledger = core.TimeLedger()
    reader = core.SnapshotReader(regions, pool.host_view("h", ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = core.Instance(core.StateImage.empty_like(manifest, device=cuda_device), ledger)
    rdma = core.AsyncRDMAEngine(pool.rdma, ledger, host="h")
    eng = core.RestoreEngine(reader, inst, rdma_engine=rdma, scatter_fn=FusedScatter())
    try:
        eng.start_completion_handler()
        eng.pre_install_hot()
        for p in reader.cold_page_indices()[:20]:
            eng.access(int(p), timeout_s=30.0)
        eng.install_zero_runs()
        eng.start_prefetcher(policy=core.LayoutOrderPolicy(16))
        assert eng.wait_prefetch_idle(timeout_s=60.0)
    finally:
        eng.stop()
        rdma.close()
    torch.cuda.synchronize()
    assert inst.all_present() and torch.equal(inst.image.buf, image.buf)
    assert eng.buffers.outstanding == 0 and eng.repair_error is None
    assert not rdma._worker.is_alive() and not eng._prefetch_thread.is_alive()


def _pod(device, n=2048, seed=2):
    """A CUDA pod: a 2048-page image (60% zero, 10% hot) published by a
    PoolMaster through the fused publish kernel."""
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    pages[rng.random(n) < 0.6] = 0
    ws = np.flatnonzero(rng.random(n) < 0.1)
    manifest = core.Manifest([core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    image = core.StateImage(manifest, torch.from_numpy(pages.reshape(-1)).to(device))
    pool = core.HierarchicalPool(16 << 20, 32 << 20, device=device)
    from repro_torch.kernels import make_fused_publish_fn

    master = core.PoolMaster(pool, publish_fn=make_fused_publish_fn())
    return pool, master, image, ws


def test_pod_fanout_demand_faults_delete_and_gc_on_card(cuda_device):
    """Four co-located restores of one snapshot through one node server on a
    CUDA pool: one read per hot chunk, demand faults through the server,
    bit-identical verified images; delete + gc return every byte, the server
    parks and leaves no thread."""
    before = set(threading.enumerate())
    pool, master, image, ws = _pod(cuda_device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    fused_publish.launches = 0
    regions = master.publish("p", image, ws)
    assert fused_publish.launches == 1
    server = core.NodePageServer("h", pool)
    orch = core.Orchestrator("h", pool, master.catalog, node_server=server)
    ris = []
    for _ in range(4):
        orch.scatter_fn = FusedScatter()
        ris.append(orch.restore("p", pre_install=False, prefetch_cold=False))
    errs = []

    def drive(ri, k):
        try:
            ri.engine.pre_install_hot()
            ri.engine.install_zero_runs()
            for p in ri.engine.reader.cold_page_indices()[k::7][:16]:
                ri.engine.access(int(p), timeout_s=30.0)   # demand faults, no prefetch yet
            ri.engine.start_prefetcher()
            assert ri.engine.wait_prefetch_idle(60.0)
        except Exception as exc:             # pragma: no cover - reported below
            errs.append(exc)

    threads = [threading.Thread(target=drive, args=(ri, k)) for k, ri in enumerate(ris)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    n_chunks = -(-regions.n_hot // core.RestoreEngine.HOT_CHUNK_PAGES)
    assert server.chunks.stats["reads"] == n_chunks
    assert server.chunks.stats["fanout_hits"] == 3 * n_chunks
    assert server.stats["fanout_installs"] > 0 and server.stats["demand_reads"] > 0
    for ri in ris:
        assert torch.equal(ri.instance.image.buf, image.buf)
        assert ri.instance.scatter_fn.stats["pages_verified"] == regions.n_hot + regions.n_cold
        assert ri.engine.walk_routes["batched"] == 1
        ri.shutdown()
    assert server.buffers.outstanding == 0
    assert master.delete("p") and master.gc() == 0
    assert (pool.cxl.free_list(), pool.rdma.free_list()) == free0
    assert pool.cxl.bytes_in_use == pool.rdma.bytes_in_use == 0
    orch.close()
    assert server._pump_thread is None and server._completion_thread is None
    assert not (set(threading.enumerate()) - before)


def test_pod_update_while_borrowed_on_card(cuda_device):
    """An update during a borrowed restore drains until shutdown; the
    borrowed restore stays bit-identical to version 0, the next is version 1."""
    pool, master, image, ws = _pod(cuda_device)
    master.publish("p", image, ws)
    image2 = core.StateImage(image.manifest, image.buf.clone())
    image2.pages_matrix()[ws[::3]] ^= 0x5A
    orch = core.Orchestrator("h", pool, master.catalog, scatter_fn=FusedScatter())
    ri = orch.restore("p", pre_install=False)
    entry = master.catalog.find("p")
    old = entry.regions
    t = threading.Thread(target=master.publish, args=("p", image2, ws), daemon=True)
    t.start()
    while entry.state.load() != core.STATE_TOMBSTONE:
        time.sleep(0.001)
    ri.engine.pre_install_hot()
    ri.engine.install_all_sync()
    torch.cuda.synchronize()
    assert torch.equal(ri.instance.image.buf, image.buf)
    assert t.is_alive() and entry.regions is old
    ri.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()
    ri2 = orch.restore("p")
    ri2.engine.install_all_sync()
    torch.cuda.synchronize()
    assert ri2.borrow.version == 1 and torch.equal(ri2.instance.image.buf, image2.buf)
    ri2.shutdown()
    orch.close()
    assert master.delete("p")
    assert pool.cxl.bytes_in_use == pool.rdma.bytes_in_use == 0


ROW_CASES = [(0, None), (1, None), (7, None), (37, None), (1000, None),
             (64, 0), (64, 5), (64, 0xFF)]


def _rows(n, fill, device, seed=0):
    """n random pages (every third zero, every seventh all-0xFF) or n pages
    of one byte value."""
    if fill is not None:
        return torch.full((n, PAGE), fill, dtype=torch.uint8, device=device)
    pages, _ = _pages(n, seed, 3)
    return torch.from_numpy(pages).to(device)


@pytest.mark.parametrize("n,fill", ROW_CASES)
def test_zero_detect_and_checksum_kernels_match_plain(cuda_device, n, fill):
    p = _rows(n, fill, cuda_device, seed=n)
    before = (zero_detect.launches, page_checksum.launches)
    z, c = zero_detect(p), page_checksum(p)
    torch.cuda.synchronize()
    assert torch.equal(z, zero_detect_ref(p)) and torch.equal(c, page_checksum_ref(p))
    assert (zero_detect.launches, page_checksum.launches) == tuple(
        b + (1 if n else 0) for b in before)
    if n:
        assert torch.equal(c, fused_publish(p, torch.zeros(n, dtype=torch.bool,
                                                           device=cuda_device)).checksums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16,
                                   torch.float64, torch.int32])
def test_zero_detect_kernel_value_semantics(cuda_device, dtype):
    width = PAGE // torch.tensor([], dtype=dtype).element_size()
    x = torch.zeros((6, width), dtype=dtype, device=cuda_device)
    if dtype.is_floating_point:
        x[1, 3] = -0.0
        x[2, :] = -0.0
        x[3, 5] = float("nan")
    x[4, width - 1] = 1
    x[5, 0] = -2
    got = zero_detect(x)
    torch.cuda.synchronize()
    assert torch.equal(got, zero_detect_ref(x))


def test_checksum_kernel_other_widths(cuda_device):
    for width in (16, 1024, 65536):
        p = torch.randint(0, 256, (33, width), dtype=torch.uint8, device=cuda_device)
        p[0] = 0xFF
        got = page_checksum(p)
        torch.cuda.synchronize()
        assert torch.equal(got, page_checksum_ref(p)), width


@pytest.mark.parametrize("n,fill", ROW_CASES)
def test_gather_and_scatter_kernels_match_plain(cuda_device, n, fill):
    rng = np.random.default_rng(n)
    p = _rows(n, fill, cuda_device, seed=n + 1)
    idx = rng.permutation(n)
    before = (page_gather.launches, page_scatter.launches)
    got = page_gather(p, idx)
    want = page_gather_ref(p, torch.from_numpy(idx).to(cuda_device))
    dest_k = torch.randint(0, 256, (n + 50, PAGE), dtype=torch.uint8, device=cuda_device)
    dest_p = dest_k.clone()
    dst = rng.permutation(n + 50)[:n]
    src = rng.integers(0, max(n, 1), n)
    page_scatter(dest_k, p, dst, src_indices=src)
    page_scatter_ref(dest_p, p, torch.from_numpy(dst).to(cuda_device),
                     torch.from_numpy(src).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(dest_k, dest_p)
    assert (page_gather.launches, page_scatter.launches) == tuple(
        b + (1 if n else 0) for b in before)


def test_gather_scatter_device_indices_and_dtypes(cuda_device):
    f = torch.randn((40, 1024), device=cuda_device)
    idx = torch.tensor([39, 0, 0, 17], device=cuda_device)
    assert torch.equal(page_gather(f, idx), f[idx])
    dest = torch.zeros((8, 1024), device=cuda_device)
    page_scatter(dest, f, torch.tensor([7, 1], device=cuda_device),
                 src_indices=torch.tensor([3, 39], device=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(dest[7], f[3]) and torch.equal(dest[1], f[39]) and not dest[0].any()
    with pytest.raises(IndexError):
        page_gather(f, np.array([40]))
    with pytest.raises(ValueError):
        page_gather(torch.zeros((4, 100), dtype=torch.uint8, device=cuda_device), [0])


@pytest.mark.parametrize("m", [0, 1, 7, 8, 9, 136_900])
def test_page_gather_kernel_row_counts(cuda_device, m):
    """No row, one, a few, and the cold set's size (one block a row)."""
    n = m + 100
    p = torch.randint(0, 256, (n, PAGE), dtype=torch.uint8, device=cuda_device)
    idx = torch.randint(0, n, (m,), device=cuda_device)
    before = page_gather.launches
    got = page_gather(p, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, page_gather_ref(p, idx))
    assert page_gather.launches == before + (1 if m else 0)


@pytest.mark.parametrize("width", [16, 1024, 4112, 8208, 65536])
def test_page_gather_kernel_other_widths(cuda_device, width):
    """Rows narrower than 4 KiB, wider ones, and widths that leave a tail
    after the 4 KiB chunks."""
    p = torch.randint(0, 256, (333, width), dtype=torch.uint8, device=cuda_device)
    idx = torch.randint(0, 333, (257,), device=cuda_device)
    got = page_gather(p, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, page_gather_ref(p, idx))


def test_page_gather_kernel_rows_past_2gib(cuda_device):
    """Rows whose byte offsets pass 2^31 in a 2.2 GB arena."""
    n = (1 << 31) // PAGE + 600
    arena = torch.zeros((n, PAGE), dtype=torch.uint8, device=cuda_device)
    far = torch.tensor([n - 1, (1 << 31) // PAGE, 3, n - 300, (1 << 31) // PAGE - 1],
                       device=cuda_device)
    arena[far] = torch.randint(1, 256, (far.numel(), PAGE), dtype=torch.uint8,
                               device=cuda_device)
    got = page_gather(arena, far)
    torch.cuda.synchronize()
    assert torch.equal(got, page_gather_ref(arena, far)) and bool(got.all())


def test_dedup_slice_small(cuda_device):
    """Three variants sharing a base at 2048 pages each, on the card: the
    kernel route and the fused route share pages, every restore is
    bit-identical, and freeing the fleet empties both stores."""
    rng = np.random.default_rng(7)
    n = 2048
    base = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    base[rng.random(n) < 0.6] = 0
    hot = np.flatnonzero(rng.random(n) < 0.1)
    cold = np.setdiff1d(np.flatnonzero(base.any(axis=1)), hot)
    manifest = core.Manifest([core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    pool = core.HierarchicalPool(16 << 20, 32 << 20, device=cuda_device,
                                 dedup_hash_fn=core.poly32_hash_fn)
    from repro_torch.kernels import make_fused_publish_fn

    for k in (zero_detect, page_checksum, page_gather, page_scatter):
        k.launches = 0
    images, regions = [], []
    for v in range(3):
        pages = base.copy()
        pages[hot[v * 4 : v * 4 + 4]] = rng.integers(1, 255, (4, PAGE), dtype=np.uint8)
        pages[cold] = rng.integers(1, 255, (cold.size, PAGE), dtype=np.uint8)
        image = core.StateImage(manifest, torch.from_numpy(pages.reshape(-1)).to(cuda_device))
        kw = {"publish_fn": make_fused_publish_fn()} if v == 2 else {}
        regions.append(core.build_snapshot(pool, image, hot, f"v{v}", dedup=True, **kw))
        images.append(image)
    assert pool.dedup_cxl.stats["unique"] == np.count_nonzero(base[hot].any(axis=1)) + 12
    for image, reg in zip(images, regions):
        ledger = core.TimeLedger()
        reader = core.SnapshotReader(reg, pool.host_view("h", ledger), pool.rdma)
        reader.invalidate_cxl()
        inst = core.Instance(core.StateImage.empty_like(manifest, device=cuda_device), ledger)
        scatter = FusedScatter() if reg.name == "v2" else None
        eng = core.RestoreEngine(reader, inst, scatter_fn=scatter)
        eng.install_all_sync()
        torch.cuda.synchronize()
        assert torch.equal(inst.image.buf, image.buf)
        assert torch.equal(core.reconstruct_image(pool, reg).buf, image.buf)
    assert all(k.launches > 0 for k in (zero_detect, page_checksum, page_gather, page_scatter))
    for reg in regions:
        core.free_snapshot(pool, reg)
    assert pool.dedup_cxl.unique_pages() == pool.dedup_rdma.unique_pages() == 0
    assert pool.cxl.bytes_in_use == pool.rdma.bytes_in_use == 0


# --------------------------------------------------------------------------
# the row-list kernels (batched restore walks)
# --------------------------------------------------------------------------

SEGMENT_CASES = [(), (0,), (1,), (37,), (255, 1, 300, 2), (7,) * 20, (2000, 999)]


def _segments(rng, device, sizes, dest_rows):
    """One source tensor a size (three spare rows each, read through a
    permutation); destinations disjoint across the segments."""
    dst = rng.permutation(dest_rows)[: sum(sizes)]
    segs, at = [], 0
    for m in sizes:
        t = torch.from_numpy(rng.integers(0, 256, (m + 3, PAGE), dtype=np.uint8)).to(device)
        t[::5] = 0xFF                                     # all-ones lanes: the wrap case
        segs.append((t, rng.permutation(m + 3)[:m], dst[at : at + m]))
        at += m
    return segs


@pytest.mark.parametrize("sizes", SEGMENT_CASES, ids=lambda s: f"{len(s)}segs-{sum(s)}rows")
def test_row_list_kernels_match_plain(cuda_device, sizes):
    """page_scatter_rows and fused_restore_rows bit-equal to their plain
    versions over ragged and empty row lists from many source tensors; one
    launch each, whatever the number of segments."""
    rng = np.random.default_rng(sum(sizes) + len(sizes))
    n = 5000
    segs = _segments(rng, cuda_device, sizes, n)
    m = sum(sizes)
    dest = torch.randint(0, 256, (n, PAGE), dtype=torch.uint8, device=cuda_device)
    want = page_scatter_rows_ref(dest.clone(), segs)
    before = page_scatter.launches
    got = page_scatter_rows(dest.clone(), segs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert page_scatter.launches == before + (1 if m else 0)
    dest_p = dest.clone()
    cs_want = fused_restore_rows_ref(dest_p, segs)
    before = fused_restore.launches
    cs = fused_restore_rows(dest, segs)
    torch.cuda.synchronize()
    assert torch.equal(dest, dest_p) and torch.equal(cs, cs_want)
    assert fused_restore.launches == before + (1 if m else 0)


@pytest.mark.parametrize("n_bad", [0, 1, 5, 300])
def test_row_list_restore_verifies_and_counts_mismatches(cuda_device, n_bad):
    """Verified installs and verify-only launches against a guest-indexed
    table: forced mismatches are named exactly, and a verify-only launch
    writes nothing."""
    rng = np.random.default_rng(n_bad)
    n = 4096
    segs = _segments(rng, cuda_device, (700, 13, 1), n)
    dst = np.concatenate([d for _t, _r, d in segs])
    table = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    table[torch.from_numpy(dst).to(cuda_device)] = fused_restore_rows_ref(None, segs)
    bad = np.sort(rng.choice(dst, n_bad, replace=False))
    table[torch.from_numpy(bad).to(cuda_device)] ^= 0x10
    dest = torch.zeros((n, PAGE), dtype=torch.uint8, device=cuda_device)
    for verify_only in (True, False):
        if n_bad:
            with pytest.raises(ChecksumMismatchError) as ei:
                fused_restore_rows(dest, segs, expected_table=table, verify_only=verify_only)
            assert np.sort(ei.value.bad_pages).tolist() == bad.tolist()
        else:
            cs = fused_restore_rows(dest, segs, expected_table=table, verify_only=verify_only)
            assert torch.equal(cs, table[torch.from_numpy(dst).to(cuda_device)])
        torch.cuda.synchronize()
        assert bool(dest.any()) == (not verify_only)      # rows are written either way
    want = page_scatter_rows_ref(torch.zeros_like(dest), segs)
    assert torch.equal(dest, want)


def test_row_list_kernels_addresses_past_2gib(cuda_device):
    """Sources and destinations whose byte offsets pass 2^31 in a 2.2 GB
    arena, in one row list with a small tensor."""
    n = (1 << 31) // PAGE + 600
    arena = torch.zeros((n, PAGE), dtype=torch.uint8, device=cuda_device)
    far = np.array([n - 1, (1 << 31) // PAGE, n - 300], np.int64)
    arena[torch.from_numpy(far).to(cuda_device)] = torch.randint(
        1, 256, (3, PAGE), dtype=torch.uint8, device=cuda_device)
    small = torch.randint(0, 256, (4, PAGE), dtype=torch.uint8, device=cuda_device)
    segs = [(arena, far, np.array([3, 9, (1 << 31) // PAGE - 1])),
            (small, None, np.array([n - 2, n - 299, (1 << 31) // PAGE + 1, 5]))]
    want = page_scatter_rows_ref(arena.clone(), segs)
    page_scatter_rows(arena, segs)
    torch.cuda.synchronize()
    assert torch.equal(arena, want)
    del want
    back = arena.clone()
    cs = fused_restore_rows(arena, segs)
    torch.cuda.synchronize()
    assert torch.equal(arena, back)
    assert torch.equal(cs, fused_restore_rows_ref(None, segs))


@pytest.mark.parametrize("width", [16, 1024, 4112, 8208, 65536])
def test_page_scatter_kernel_other_widths(cuda_device, width):
    """Rows narrower and wider than 4 KiB (moved in 4 KiB pieces), through
    both forms: host indices and device-resident ones."""
    rng = np.random.default_rng(width)
    src = torch.randint(0, 256, (300, width), dtype=torch.uint8, device=cuda_device)
    dest = torch.randint(0, 256, (500, width), dtype=torch.uint8, device=cuda_device)
    dst = rng.permutation(500)[:257]
    rows = rng.integers(0, 300, 257)
    want = page_scatter_ref(dest.clone(), src, torch.from_numpy(dst).to(cuda_device),
                            torch.from_numpy(rows).to(cuda_device))
    got = page_scatter(dest.clone(), src, dst, src_indices=rows)
    got_dev = page_scatter(dest.clone(), src, torch.from_numpy(dst).to(cuda_device),
                           src_indices=torch.from_numpy(rows).to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_dev, want)


def test_row_list_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    dest = torch.zeros((8, PAGE), dtype=torch.uint8, device=cuda_device)
    raw = torch.zeros(3 * PAGE + 16, dtype=torch.uint8, device=cuda_device)
    misaligned = raw[8 : 8 + 3 * PAGE].view(3, PAGE)
    for fn in (page_scatter_rows, fused_restore_rows):
        with pytest.raises(ValueError):
            fn(dest, [(misaligned, None, np.array([0, 1, 2]))])
        with pytest.raises(IndexError):
            fn(dest, [(dest[:2].clone(), None, np.array([0, 8]))])
        with pytest.raises(ValueError):
            fn(dest, [(torch.zeros((2, PAGE), dtype=torch.uint8), None, np.array([0, 1]))])
    with pytest.raises(ValueError):
        fused_restore_rows(None, [(dest, None, np.arange(8))], verify_only=True)


# --------------------------------------------------------------------------
# flash attention and the dense model
# --------------------------------------------------------------------------

# Against the float32 reference on the upcast inputs: float32 within 1e-5
# (summation order), bf16 within one round-to-nearest, 2^-8 |want| + 1e-4.
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-4)}


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dk,dv", [
    (1, 4, 4, 128, 128, 64, 64),      # MHA
    (2, 8, 2, 256, 256, 64, 64),      # GQA 4:1
    (1, 4, 1, 100, 300, 64, 64),      # MQA, ragged Sq < Skv
    (1, 2, 2, 77, 130, 192, 128),     # ragged, Dk != Dv (MLA)
    (1, 2, 1, 64, 64, 256, 256),      # the largest head dims
    (2, 6, 3, 1, 33, 32, 16),         # one query row
    (1, 2, 2, 128, 128, 128, 128),    # one tile, group 1
    (2, 6, 2, 1, 300, 128, 128),      # Sq = 1, group 3
    (1, 8, 2, 1000, 1500, 128, 128),  # Sq = 1000 < Skv = 1500, group 4
    (1, 4, 4, 130, 130, 64, 64),      # Skv = 130: one key past a tile
    (1, 4, 1, 256, 512, 128, 128),    # MQA, D = 128
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, b, hq, hkv, sq, skv, dk, dv, causal, dtype):
    """Each call against the float32 reference on the upcast inputs, on the
    route the rule gives it: bf16 with (Dk, Dv) in ``ops.SM90_DK_DV`` ((64,
    64), (128, 128), MLA's (192, 128)) on the tensor cores, everything else
    on the SIMT kernel."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, ops

    g = torch.Generator(device=cuda_device).manual_seed(sq * 7 + dk)
    q = torch.randn(b, hq, sq, dk, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(b, hkv, skv, dk, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, skv, dv, generator=g, device=cuda_device).to(dtype)
    want_route = "sm90" if dtype == torch.bfloat16 and (dk, dv) in ops.SM90_DK_DV else "simt"
    assert ops.route(q, k, v) == want_route
    before, by_route = flash_attention.launches, ops.launches_by_route()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert ops.launches_by_route() == {r: n + (r == want_route) for r, n in by_route.items()}
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    rtol, atol = FLASH_TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.allclose(got.float(), want, rtol=rtol, atol=atol)


def test_flash_kernel_takes_strided_views(cuda_device):
    """The model hands the kernel (B, S, H, D) projections viewed as
    (B, H, S, D); a non-contiguous last dim is copied first."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref

    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(2, 70, 6, 32, generator=g, device=cuda_device).transpose(1, 2)
    k = torch.randn(2, 90, 2, 32, generator=g, device=cuda_device).transpose(1, 2)
    v = torch.randn(2, 2, 16, 90, generator=g, device=cuda_device).transpose(2, 3)
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_sm90_takes_model_views_without_copy(cuda_device, d):
    """bf16 (B, S, H, D) projections viewed as (B, H, S, D) go to the tensor
    cores as they are: the call allocates its output and nothing else."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, ops

    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(2, 300, h, d, generator=g, device=cuda_device).to(torch.bfloat16)
               .transpose(1, 2) for h in (6, 2, 2))
    assert ops.route(q, k, v) == "sm90"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    before = flash_attention.launches_sm90
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches_sm90 == before + 1
    assert torch.cuda.max_memory_allocated() - start == got.numel() * got.element_size()
    want = attention_ref(q.float(), k.float(), v.float(), causal=True)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    assert torch.allclose(got.float(), want, rtol=rtol, atol=atol)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels import flash_attention

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    before = flash_attention.launches
    for q, k, v, causal in [
        (z(1, 4, 8, 16, dtype=torch.float16), z(1, 2, 8, 16, dtype=torch.float16),
         z(1, 2, 8, 16, dtype=torch.float16), True),                  # dtype
        (z(1, 3, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16), True),       # Hq % Hkv
        (z(1, 4, 8, 320), z(1, 2, 8, 320), z(1, 2, 8, 16), True),     # Dk > 256
        (z(1, 4, 9, 16), z(1, 2, 8, 16), z(1, 2, 8, 16), True),       # causal Sq > Skv
        (z(1, 4, 8, 16), z(1, 2, 8, 16).cpu(), z(1, 2, 8, 16), True),  # devices differ
    ]:
        with pytest.raises(ValueError):
            flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before


def test_reduced_model_on_card_matches_cpu(cuda_device):
    """A reduced phi4-mini forward (flash kernel) and generate (decode path)
    on the card against the same parameters on the CPU: float32 compute
    within 1e-4 relative (matmul order on the card), tokens equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels import flash_attention
    from repro_torch.models import build
    from repro_torch.serve import new_instance

    cfg = get_config("phi4-mini-3.8b").reduced(compute_dtype="float32", n_layers=3)
    m_cpu, m_gpu = build(cfg, device="cpu"), build(cfg, device=cuda_device)
    p_cpu = m_cpu.init(0)
    p_gpu = params_from_numpy(params_to_numpy(p_cpu), device=cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    want, _ = m_cpu.forward(p_cpu, {"tokens": tokens})
    before = flash_attention.launches
    got, _ = m_gpu.forward(p_gpu, {"tokens": tokens.to(cuda_device)})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    assert rel < 1e-4, rel
    out_cpu = new_instance(cfg, p_cpu, 2, 48, device="cpu").generate(tokens[:, :32], 8)
    out_gpu = new_instance(cfg, p_gpu, 2, 48, device=cuda_device).generate(tokens[:, :32], 8)
    np.testing.assert_array_equal(out_gpu, out_cpu)


def test_restore_server_on_card_serves_the_original_tokens(cuda_device):
    """Serverless cold start of a reduced phi4-mini on the card: published
    from device tensors by save_checkpoint (one fused publish), restored into
    a claimed skeleton with the cold tail prefetched, serving the tokens of
    an instance built on the original parameters; every restore launch
    accounted and every pool byte back after delete."""
    from repro_torch.checkpoint.ckpt import flatten_state, save_checkpoint
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import make_fused_publish_fn
    from repro_torch.models import build
    from repro_torch.serve import new_instance
    from repro_torch.serve.coldstart import SkeletonPool, restore_server

    before = set(threading.enumerate())
    cfg = get_config("phi4-mini-3.8b").reduced(n_layers=3, vocab=4096,
                                               name="phi4-mini-coldstart-card")
    params = build(cfg, device=cuda_device).init(5)
    prompts = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (2, 12)))
    want = new_instance(cfg, params, 2, 20, device=cuda_device).generate(prompts, 8)
    pool = core.HierarchicalPool(16 << 20, 32 << 20, device=cuda_device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    master = core.PoolMaster(pool, publish_fn=make_fused_publish_fn())
    manifest = core.StateImage.layout(flatten_state({"params": params}))
    table = manifest.by_name()["params/embed/table"]
    ws = np.setdiff1d(np.arange(manifest.total_pages),
                      np.arange(table.first_page + 3, table.first_page + table.page_count))
    fused_publish.launches = fused_restore.launches = 0
    image, stats = save_checkpoint(master, "m", {"params": params}, step=0, working_set=ws)
    assert fused_publish.launches == 1 and image.device.type == "cuda"
    assert stats["hot"] == ws.size and stats["cold"] == table.page_count - 3
    sp = SkeletonPool(cfg, batch=2, max_len=20, target_size=1, device=cuda_device)
    orch = core.Orchestrator("h", pool, master.catalog, prefetch_cold=True,
                             scatter_fn=FusedScatter())
    out = restore_server(orch, "m", sp.claim(), params)
    torch.cuda.synchronize()
    st = out["stats"]
    assert st["walk_routes"]["batched"] == 1
    scatter = orch.scatter_fn.stats
    assert scatter["pages_verified"] == stats["hot"] + stats["cold"]
    n_chunks = -(-stats["hot"] // core.RestoreEngine.HOT_CHUNK_PAGES)
    assert fused_restore.launches == scatter["batches"] - n_chunks + 1 + st["flushes"]
    for name, t in flatten_state(out["state"]).items():
        assert t.device.type == "cuda" and torch.equal(t, flatten_state({"params": params})[name])
    got = out["instance"].generate(prompts, 8)
    np.testing.assert_array_equal(got, want)
    sp.close()
    orch.close()
    assert master.delete("m") and (pool.cxl.free_list(), pool.rdma.free_list()) == free0
    assert not (set(threading.enumerate()) - before)


def test_recurate_on_card_publishes_once_and_restores_version_one(cuda_device):
    pool, master, image, ws = _pod(cuda_device)
    heat = core.HeatRegistry(clock=pool.clock, half_life_s=1e6)
    master.heat = heat
    regions = master.publish("p", image, ws)
    orch = core.Orchestrator("h", pool, master.catalog, heat=heat, scatter_fn=FusedScatter())
    traced = np.random.default_rng(3).choice(
        np.flatnonzero(~np.isin(np.arange(regions.total_pages), ws)
                       & image.pages_matrix().any(dim=1).cpu().numpy()), 40, replace=False)
    for _ in range(2):
        ri = orch.restore("p")
        for p in traced.tolist():
            ri.engine.access(p, timeout_s=30.0)
        ri.shutdown()
    fused_publish.launches = 0
    v1 = master.recurate("p")
    assert v1 is not None and v1.version == 1 and fused_publish.launches == 1
    hot = core.SnapshotReader(v1, pool.host_view("x"), pool.rdma).hot_page_indices()
    assert set(traced.tolist()) <= set(hot.tolist())
    orch.scatter_fn = FusedScatter()
    ri = orch.restore("p")
    ri.engine.install_all_sync()
    torch.cuda.synchronize()
    assert ri.borrow.version == 1 and torch.equal(ri.instance.image.buf, image.buf)
    assert ri.instance.scatter_fn.stats["pages_verified"] == v1.n_hot + v1.n_cold
    ri.shutdown()
    orch.close()
    assert master.delete("p")


def test_batched_walk_repairs_a_row_changed_after_the_preverify(cuda_device, monkeypatch):
    """On the card, a hot row flipped after the walk's verify-only launch and
    flipped back once the walk read it: the flush's launch names the page,
    the repair re-reads it from the tier, the image ends bit-identical."""
    rng = np.random.default_rng(4)
    n = 1024
    pages = rng.integers(0, 256, (n, PAGE), dtype=np.uint8)
    manifest = core.Manifest([core.ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    image = core.StateImage(manifest, torch.from_numpy(pages.reshape(-1)).to(cuda_device))
    pool = core.HierarchicalPool(8 << 20, 8 << 20, device=cuda_device)
    from repro_torch.kernels import make_fused_publish_fn

    regions = core.build_snapshot(pool, image, np.arange(0, n, 3), "r",
                                  publish_fn=make_fused_publish_fn())
    reader = core.SnapshotReader(regions, pool.host_view("h"), pool.rdma)
    reader.invalidate_cxl()
    inst = core.Instance(core.StateImage.empty_like(manifest, device=cuda_device))
    eng = core.RestoreEngine(reader, inst, scatter_fn=FusedScatter())
    at = regions.hot_off + 5 * PAGE + 100
    verify, read = FusedScatter.verify_rows, reader.view.read

    def verify_then_flip(self, segments):
        ok = verify(self, segments)
        pool.cxl.buf[at] ^= 0xFF
        return ok

    def read_then_heal(off, nbytes):
        out = read(off, nbytes)
        if off <= at < off + nbytes:
            pool.cxl.buf[at] ^= 0xFF
        return out

    monkeypatch.setattr(FusedScatter, "verify_rows", verify_then_flip)
    reader.view.read = read_then_heal
    eng.pre_install_hot()
    eng.install_all_sync()
    torch.cuda.synchronize()
    assert eng.walk_routes["batched"] == 2
    assert eng.repair_stats["checksum_mismatches"] == 1
    assert eng.repair_stats["checksum_repairs"] == 1
    assert inst.all_present() and torch.equal(inst.image.buf, image.buf)
    assert inst.scatter_fn.stats["pages_verified"] == regions.n_hot + regions.n_cold


def _sim_scenarios():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import sim_scenarios

    return sim_scenarios


@pytest.mark.parametrize("name", ["cxl_poison_during_shared_restore",
                                  "dedup_owner_crash_mid_republish"])
def test_sim_scenario_on_card_equals_its_cpu_run(cuda_device, name):
    """A chaos scenario (fused publish, verified fused restore, poison
    repair) and a dedup one: trace, events, restored ledgers, catalogs,
    free lists and fault stats on the card equal the CPU run's."""
    sims = _sim_scenarios()
    fn = sims.SCENARIOS[name]
    launches_before = fused_restore.launches + page_scatter.launches
    c, _cpu_s, _cuda_s = sims.cuda_parity(fn, sims.scenario_seed(name))
    assert c.pool.cxl.buf.device.type == "cuda" and c.restored
    assert fused_restore.launches + page_scatter.launches > launches_before


def test_topology_scenario_on_card_equals_its_cpu_run(cuda_device):
    """The replicated update under routed borrowers on three pods: the
    card's run equals the CPU's, replica stats included."""
    sims = _sim_scenarios()
    fn = sims.TOPOLOGY_SCENARIOS["replicated_publish_and_update"]
    seed = sims.topology_seed("replicated_publish_and_update")
    c, _cpu_s, _cuda_s = sims.cuda_parity(fn, seed)
    cpu = fn(seed, "cpu")
    assert c.replicas.stats == cpu.replicas.stats and c.router.stats == cpu.router.stats
    assert all(p.pool.rdma.buf.device.type == "cuda" for p in c.pods)


def _fleet_bench():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import fleet_bench

    return fleet_bench


@pytest.mark.parametrize("fn,name", [("run", "fleet_bench_quick.json"),
                                     ("run_multipod", "fleet_bench_multipod_quick.json")])
def test_fleet_bench_quick_on_card_equals_committed(cuda_device, tmp_path, monkeypatch, fn,
                                                    name):
    """The fleet bench twin with its pod on the card (every publish one
    fused launch) gives the committed quick results key for key."""
    import json
    from pathlib import Path

    fb = _fleet_bench()
    monkeypatch.setattr(fb, "OUT", tmp_path)
    before = fused_publish.launches
    got = json.loads(json.dumps(getattr(fb, fn)(quick=True, device="cuda")))
    want = json.loads((Path(__file__).resolve().parents[1] / "experiments" / name).read_text())
    assert got == want
    assert fused_publish.launches - before == got["fleet"]["n_types"]


def test_fleet_scale_variant_on_card(cuda_device):
    """Two scale-pod variants of one base group published into a dedup pod
    on the card, profiled exactly and restored verified and bit-identical
    to their images made again from the seed; the pool then back to zero."""
    import math

    from repro_torch.serve.strategies import modeled_concurrent_restore_s

    fb = _fleet_bench()
    fleet = fb.synthesize_fleet(2, 1, 10.0, seed=0)
    dims = (256, 128, 64, 24)
    pool, master, walls = fb.build_scale_pod(fleet, *dims, seed=3, device="cuda")
    assert len(walls) == 2
    profiles, err = fb.profile_pod(pool, master, fleet)
    # fn1 holds its 24 delta rows and the 24 base rows fn0 replaced alone
    assert err == 0.0 and profiles[1].shared_base_bytes == (256 - 2 * 24) * PAGE
    for f in fleet:
        regions = master.catalog.find(f.name).regions
        reader = core.SnapshotReader(regions, pool.host_view(f"t-{f.name}"), pool.rdma)
        assert math.isclose(profiles[f.fn_id].cold_start_s(4),
                            modeled_concurrent_restore_s(reader, 4), rel_tol=1e-12)
        reader.invalidate_cxl()
        img = fb.scale_image(f, *dims, seed=3, device="cuda")
        inst = core.Instance(core.StateImage.empty_like(img.manifest, device="cuda"))
        core.RestoreEngine(reader, inst, scatter_fn=FusedScatter()).install_all_sync()
        assert torch.equal(inst.image.buf, img.buf)
        assert inst.scatter_fn.stats["pages_verified"] == regions.n_hot + regions.n_cold
    fb.free_pod(master)
    assert pool.cxl.bytes_in_use == pool.rdma.bytes_in_use == 0


def test_compress_cold_without_zstandard_on_card(cuda_device, monkeypatch):
    """Without ``zstandard`` a compress_cold publish on the card is the
    uncompressed publish: regions and tier bytes equal."""
    import dataclasses

    from repro_torch.core import snapshot
    from repro_torch.kernels import make_fused_publish_fn

    monkeypatch.setattr(snapshot, "_zstd", None)
    pages, ws = _publish_inputs(3000, seed=11, zero_every=3, ws_kind="rand", device="cuda")
    image = core.StateImage(core.Manifest([core.ArrayExtent("g", 0, pages.numel(),
                                                            (pages.numel(),), "uint8")],
                                          3000), pages.reshape(-1))
    working_set = torch.nonzero(ws).flatten().cpu().numpy()
    out = []
    for compress in (True, False):
        pool = core.HierarchicalPool(64 << 20, 64 << 20, device="cuda")
        out.append((pool, core.build_snapshot(pool, image, working_set, "z",
                                              compress_cold=compress,
                                              publish_fn=make_fused_publish_fn())))
    (pa, ra), (pb, rb) = out
    assert not ra.cold_compressed and ra.ci_size == 0
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
    assert torch.equal(pa.cxl.buf, pb.cxl.buf) and torch.equal(pa.rdma.buf, pb.rdma.buf)


def _smoke():
    """``chip_smoke`` (the repo's root on the path; it puts scripts/ there)."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", ["dedup_bench", "fault_bench", "adaptive_bench",
                                  "concurrency_bench", "breakdown", "serving_bench",
                                  "characterization", "runlength", "scalability",
                                  "kernel_bench"])
def test_bench_twin_on_card_holds_its_committed_file(cuda_device, name, tmp_path):
    """Each bench twin at its quick configuration (the twins of
    ``chip_smoke.SINGLE_CONFIG`` have one) on the card: every key held to
    its committed CPU output (floats within 1e-12 relative,
    ``model_err_max`` within 1e-12; wall clocks, the brownout's breaker
    rejections and kernel_bench's measured section aside), every criterion
    true, launches exact."""
    cs = _smoke()
    rep = cs.bench_twin(torch, name, True, tmp_path)
    assert rep["compared"] and all(c["floats"] >= c["floats_bit_equal"]
                                   for c in rep["compared"].values())


def test_kernel_bench_quick_on_card(cuda_device, tmp_path, monkeypatch):
    """kernel_bench's quick tier on the card: the six wrappers launch their
    kernels (as many times as the CPU tally of the same run), fused and
    piecemeal agree bit for bit, every criterion true, the modeled keys the
    committed file's."""
    cs = _smoke()
    import kernel_bench

    monkeypatch.setattr(kernel_bench, "OUT", tmp_path)
    wrappers = cs.data_plane_wrappers()
    for k in wrappers.values():
        k.launches = 0
    out = kernel_bench.run(quick=True, device="cuda")
    launches = {n: k.launches for n, k in wrappers.items()}
    assert launches == cs.BENCH_LAUNCHES["kernel_bench"]["quick"]
    assert all(out["criteria"].values()) and out["config"] == {"tier": "quick",
                                                               "backend": "cuda"}
    committed = json.loads((cs.ROOT / "experiments" / "torch" /
                            "kernel_bench.json").read_text())
    assert out["modeled"] == committed["modeled"]


def test_serve_coldstart_quick_on_card(cuda_device, capsys):
    """The serve_coldstart twin's ``--quick`` on the card: pyaes's strategy
    table, a warm restore of the reduced xlstm-125m with its hot pages
    pre-installed, and two served tokens within its vocabulary."""
    _smoke()
    import serve_coldstart

    assert serve_coldstart.main(["--quick", "--device", "cuda"]) == 0
    lines = capsys.readouterr().out.splitlines()
    warm = next(line for line in lines if line.startswith("warm restore:"))
    assert int(warm.split("pre-installed ")[1].split()[0]) > 0
    tokens = json.loads(next(line for line in lines
                             if line.startswith("served tokens:")).split(":", 1)[1])
    assert len(tokens) == 2 and all(0 <= t < 512 for t in tokens)


# --------------------------------------------------------------------------
# the flash-attention backward
# --------------------------------------------------------------------------

# Against autograd through attention_ref on the inputs upcast to float32, per
# gradient tensor: float32 within 1e-4 max|want| + 1e-6, bf16 within 2^-6
# max|want| + 1e-4.
BWD_TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (2.0 ** -6, 1e-4)}

BWD_CASES = [
    (1, 4, 4, 128, 128, 64),       # MHA
    (2, 8, 2, 256, 256, 128),      # GQA 4:1
    (1, 6, 2, 100, 300, 64),       # ragged Sq < Skv
    (1, 6, 3, 77, 77, 128),        # S not a multiple of the tile
    (1, 4, 2, 70, 90, 256),        # the largest head dim (32-row tiles)
    (2, 4, 1, 1, 33, 32),          # one query row, D = 32
    (1, 6, 2, 100, 300, 80),       # Zamba2's D = 80, GQA 3:1, ragged Sq < Skv
]


def _bwd_inputs(shape, dtype, device, seed):
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, hq, sq, d, generator=g, device=device).to(dtype)
    k = torch.randn(b, hkv, skv, d, generator=g, device=device).to(dtype)
    v = torch.randn(b, hkv, skv, d, generator=g, device=device).to(dtype)
    do = torch.randn(b, hq, sq, d, generator=g, device=device).to(dtype)
    return q, k, v, do


def _autograd_want(q, k, v, do, causal):
    from repro_torch.kernels.flash_attention import attention_ref

    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    out = attention_ref(qf, kf, vf, causal=causal)
    return torch.autograd.grad(out, (qf, kf, vf), do.float())


@pytest.mark.parametrize("shape", BWD_CASES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_autograd(cuda_device, shape, causal, dtype):
    """``flash_attention`` under autograd on the card (forward with its
    log-sum-exp on the route the rule gives, then the backward on its route:
    the tensor-core kernel for bf16 with (D, D) in ``ops.SM90_DK_DV``, the
    SIMT kernel otherwise) against autograd through the float32 reference;
    one backward launch."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops

    q, k, v, do = _bwd_inputs(shape, dtype, cuda_device, sum(shape))
    want = _autograd_want(q, k, v, do, causal)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    route = "sm90" if dtype == torch.bfloat16 and (shape[5],) * 2 in ops.SM90_DK_DV else "simt"
    assert ops.bwd_route(q, k, v, do) == route
    before = flash_attention_bwd.launches
    by_route = ops.launches_by_route(flash_attention_bwd)
    fwd_before = flash_attention.launches
    out = flash_attention(qg, kg, vg, causal=causal)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    by_route[route] += 1
    assert ops.launches_by_route(flash_attention_bwd) == by_route
    assert flash_attention.launches == fwd_before + 1
    rtol, atol = BWD_TOL[dtype]
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g.float() - w).abs().max())
        assert err <= rtol * float(w.abs().max()) + atol, (name, err, float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic_and_matches_plain(cuda_device, dtype):
    """Two launches on the same inputs give the same bits (no float atomics),
    and the kernel agrees with ``flash_attention_bwd_ref`` on the same
    forward output and log-sum-exp."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention.ops import _forward

    from repro_torch.kernels.flash_attention.ops import bwd_route

    q, k, v, do = _bwd_inputs((1, 12, 4, 333, 333, 128), dtype, cuda_device, 5)
    assert bwd_route(q, k, v, do) == ("sm90" if dtype == torch.bfloat16 else "simt")
    out, lse = _forward(q, k, v, True, 128 ** -0.5, with_lse=True)
    a = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    b = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    plain = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    rtol, atol = BWD_TOL[dtype]
    for x, y, p in zip(a, b, plain):
        assert torch.equal(x, y)
        err = float((x.float() - p.float()).abs().max())
        assert err <= rtol * float(p.float().abs().max()) + atol


def _simt_bwd(q, k, v, out, lse, do, causal):
    """The SIMT backward kernel through its binding, whatever the route rule
    would pick (uncounted)."""
    from repro_torch.kernels.flash_attention import kernel

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    kernel.flash_attention_bwd(q, k, v, out, do, lse, delta, dq, dk, dv, q.shape[3] ** -0.5,
                               causal)
    return dq, dk, dv


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_sm90_and_simt_agree(cuda_device, d, causal):
    """The tensor-core and SIMT backward kernels on the same bf16 inputs (GQA
    3:1, ragged Sq < Skv): each within the bf16 limit of autograd through the
    float32 reference, and of each other."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import _forward, bwd_route

    q, k, v, do = _bwd_inputs((1, 6, 2, 200, 333, d), torch.bfloat16, cuda_device, d + causal)
    assert bwd_route(q, k, v, do) == "sm90"
    out, lse = _forward(q, k, v, causal, d ** -0.5, with_lse=True)
    sm90 = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    simt = _simt_bwd(q, k, v, out, lse, do, causal)
    want = _autograd_want(q, k, v, do, causal)
    torch.cuda.synchronize()
    rtol, atol = BWD_TOL[torch.bfloat16]
    for name, a, b, w in zip("qkv", sm90, simt, want):
        for got, ref in ((a, w), (b, w), (a, b.float())):
            err = float((got.float() - ref).abs().max())
            assert err <= rtol * float(ref.abs().max()) + atol, (name, err)


def _assert_sm90_and_simt_agree(q, k, v, do, causal):
    """The tensor-core forward and backward and the SIMT kernels on the same
    bf16 inputs: each within the bf16 limit of the float32 reference (the
    forward within 2^-8 |want| + 1e-4, each gradient within 2^-6 max|want| +
    1e-4), and two launches of each tensor-core kernel bit-equal."""
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bwd, kernel
    from repro_torch.kernels.flash_attention.ops import _forward, bwd_route, route

    assert route(q, k, v) == bwd_route(q, k, v, do) == "sm90"
    scale = q.shape[3] ** -0.5
    out, lse = _forward(q, k, v, causal, scale, with_lse=True)
    out2, lse2 = _forward(q, k, v, causal, scale, with_lse=True)
    simt_out = torch.empty_like(out)
    kernel.flash_attention(q, k, v, simt_out, scale, causal)
    want_out = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    sm90 = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    simt = _simt_bwd(q, k, v, out, lse, do, causal)
    want = _autograd_want(q, k, v, do, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    for got in (out, simt_out):
        assert got.shape == want_out.shape
        assert torch.allclose(got.float(), want_out, rtol=rtol, atol=atol)
    rtol, atol = BWD_TOL[torch.bfloat16]
    for name, a, a2, b, w in zip("qkv", sm90, again, simt, want):
        assert torch.equal(a, a2), name
        assert a.shape == b.shape == w.shape
        for got in (a, b):
            err = float((got.float() - w).abs().max())
            assert err <= rtol * float(w.abs().max()) + atol, (name, err)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mla_sm90_and_simt_agree(cuda_device, causal):
    """At MLA's Dk = 192, Dv = 128 (bf16, GQA 2:1, ragged Sq < Skv) the
    tensor-core and SIMT kernels agree with the float32 reference and the
    tensor-core ones are deterministic (``_assert_sm90_and_simt_agree``)."""
    g = torch.Generator(device=cuda_device).manual_seed(192 + causal)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(torch.bfloat16)

    _assert_sm90_and_simt_agree(randn(1, 8, 200, 192), randn(1, 4, 333, 192),
                                randn(1, 4, 333, 128), randn(1, 8, 200, 128), causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_d80_sm90_and_simt_agree(cuda_device, causal):
    """The same at Zamba2's D = 80 (bf16, GQA 3:1, ragged Sq < Skv past a
    128-row tile)."""
    _assert_sm90_and_simt_agree(
        *_bwd_inputs((1, 6, 2, 200, 333, 80), torch.bfloat16, cuda_device, 80 + causal), causal)


def _kernel_resources(lib: str, pattern: str) -> dict:
    """``{"REG", "STACK", "SHARED", "LOCAL", "HGMMA"}`` of the one kernel of a
    built kernel library whose mangled name holds ``pattern``, as
    ``cuobjdump -res-usage`` and ``-sass`` read it."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build

    build.load(lib)
    tool = "/usr/local/cuda/bin/cuobjdump"
    tool = tool if Path(tool).exists() else shutil.which("cuobjdump")
    assert tool, "the CUDA toolkit's cuobjdump is needed to read the kernels' resources"
    path = str(build.lib_path(lib))
    res = subprocess.run([tool, "-res-usage", path], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    usage = [u for name, u in re.findall(r"Function (\S+):\s*(REG:\d+[^\n]*)", res)
             if pattern in name]
    code = [part for part in sass.split("Function : ")[1:]
            if pattern in part.split(None, 1)[0]]
    assert len(usage) == len(code) == 1, (pattern, len(usage), len(code))
    out = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", usage[0])}
    out["HGMMA"] = code[0].count("HGMMA")
    return out


@pytest.mark.parametrize("lib,kernels", [
    ("flash_attention_sm90", ("flash_sm90_kernel",)),
    ("flash_attention_bwd_sm90", ("dkdv_kernel", "dq_kernel")),
])
def test_flash_sm90_d80_kernels_use_tensor_cores_without_spill(cuda_device, lib, kernels):
    """The (80, 80) instantiations of the tensor-core forward and of both
    backward kernels: wgmma in their SASS (HGMMA > 0) and no local memory
    (no spill), as ``cuobjdump`` reads the built library."""
    for kern in kernels:
        got = _kernel_resources(lib, f"{kern}ILi80ELi80E")
        assert got["LOCAL"] == 0 and got["HGMMA"] > 0, (kern, got)


def test_flash_bwd_unaligned_dout_takes_simt(cuda_device):
    """A dO view whose rows are not a multiple of 16 bytes (no TMA map takes
    it) goes to the SIMT kernel as it is, with no copy, and gives the
    gradients the aligned dO gives on the tensor-core route within the bf16
    limit."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops

    q, k, v, do = _bwd_inputs((1, 8, 2, 150, 150, 128), torch.bfloat16, cuda_device, 3)
    view = torch.empty(1, 8, 150, 132, dtype=torch.bfloat16, device=cuda_device)[..., :128]
    view.copy_(do)
    assert ops.bwd_route(q, k, v, do) == "sm90" and ops.bwd_route(q, k, v, view) == "simt"
    out, lse = ops._forward(q, k, v, True, 128 ** -0.5, with_lse=True)
    by_route = ops.launches_by_route(flash_attention_bwd)
    got = flash_attention_bwd(q, k, v, out, lse, view, causal=True)
    aligned = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    assert ops.launches_by_route(flash_attention_bwd) == {"sm90": by_route["sm90"] + 1,
                                                          "simt": by_route["simt"] + 1}
    rtol, atol = BWD_TOL[torch.bfloat16]
    for a, b in zip(got, aligned):
        assert float((a.float() - b.float()).abs().max()) <= \
            rtol * float(b.float().abs().max()) + atol


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                     (torch.float32, 128), (torch.float32, 96),
                                     (torch.bfloat16, 80)])
def test_flash_forward_lse_matches_logsumexp(cuda_device, dtype, d):
    """The forward's log-sum-exp on each route against ``torch.logsumexp`` of
    the float32 scaled scores (causal, ragged Sq < Skv)."""
    from repro_torch.kernels.flash_attention.ops import SM90_DK_DV, _forward, route

    q, k, v, _ = _bwd_inputs((1, 8, 2, 200, 260, d), dtype, cuda_device, d)
    sm90 = dtype == torch.bfloat16 and (d, d) in SM90_DK_DV
    assert route(q, k, v) == ("sm90" if sm90 else "simt")
    _, lse = _forward(q, k, v, True, d ** -0.5, with_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float().repeat_interleave(4, 1)) * d ** -0.5
    pos = torch.arange(260, device=cuda_device)
    mask = pos[None, :] > pos[:200, None] + 60
    want = torch.logsumexp(s.masked_fill(mask, float("-inf")), dim=-1)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert float((lse - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-5


def test_serving_forward_unchanged_by_the_backward(cuda_device):
    """Without grad the forward writes no log-sum-exp and saves nothing: the
    same bits as the forward under autograd, one launch each, an output with
    no history."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import ops

    q, k, v, _ = _bwd_inputs((1, 24, 8, 300, 300, 128), torch.bfloat16, cuda_device, 1)
    before = ops.launches_by_route()
    plain = flash_attention(q, k, v)
    assert plain.grad_fn is None and not plain.requires_grad
    qg = q.clone().requires_grad_(True)
    graded = flash_attention(qg, k, v)
    torch.cuda.synchronize()
    assert graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())
    assert ops.launches_by_route() == {"sm90": before["sm90"] + 2, "simt": before["simt"]}


def test_flash_bwd_refuses_what_the_kernel_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    before = flash_attention_bwd.launches
    q, k, v = z(1, 4, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 8)        # dO at Dk, not Dv
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, z(1, 4, 8, 8), z(1, 4, 8), z(1, 4, 8, 16))
    q, k, v = z(1, 4, 8, 320), z(1, 2, 8, 320), z(1, 2, 8, 8)      # Dk past 256
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, z(1, 4, 8, 8), z(1, 4, 8), z(1, 4, 8, 8))
    q, k, v = z(1, 4, 8, 16), z(1, 2, 8, 16), z(1, 2, 8, 16)
    with pytest.raises(ValueError):                                 # lse of another shape
        flash_attention_bwd(q, k, v, z(1, 4, 8, 16), z(1, 4, 9), z(1, 4, 8, 16))
    assert flash_attention_bwd.launches == before


def test_two_layer_train_step_on_card_matches_cpu(cuda_device):
    """A reduced phi4-mini's loss and every gradient on the card (flash
    forward with its log-sum-exp, the backward kernel, remat on) against the
    same parameters and batch on the CPU, float32 compute: within 1e-4
    relative (matmul and softmax summation order on the card)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.models import build
    from repro_torch.train.trainstep import make_loss_fn
    from repro_torch.tree import tree_leaves

    cfg = get_config("phi4-mini-3.8b").reduced(compute_dtype="float32", n_layers=2, remat=True)
    p_cpu = build(cfg, device="cpu").init(0)
    host = params_to_numpy(p_cpu)
    batch = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=96, global_batch=2)).batch_at(0)
    losses, grads = [], []
    for device in ("cpu", cuda_device):
        model = build(cfg, device=device)
        params = params_from_numpy(host, device=device)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        fwd, bwd = ops.flash_attention.launches, flash_attention_bwd.launches
        loss, _ = make_loss_fn(model)(params, b)
        loss.backward()
        if device != "cpu":
            torch.cuda.synchronize()
            assert ops.flash_attention.launches == fwd + 2 * cfg.n_layers       # remat
            assert flash_attention_bwd.launches == bwd + cfg.n_layers
        losses.append(float(loss.detach()))
        grads.append([t.grad.cpu() for t in tree_leaves(params)])
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    for g_cpu, g_gpu in zip(*grads):
        assert float((g_gpu - g_cpu).abs().max()) <= 1e-4 * float(g_cpu.abs().max()) + 1e-7


def test_bf16_train_step_backward_goes_to_sm90(cuda_device):
    """A reduced phi4-mini with 64-wide heads, bf16 compute, remat on: one
    loss and backward on the card launches every attention backward on the
    tensor-core route (autograd's dO and the model's transposed projections
    take no copy), and every gradient is finite."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.models import build
    from repro_torch.train.trainstep import make_loss_fn
    from repro_torch.tree import tree_leaves

    cfg = get_config("phi4-mini-3.8b").reduced(compute_dtype="bfloat16", n_layers=2, d_head=64,
                                                remat=True)
    model = build(cfg, device=cuda_device)
    params = model.init(0)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=96, global_batch=2)).batch_at(0)
    b = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    fwd = ops.launches_by_route()
    bwd = ops.launches_by_route(flash_attention_bwd)
    loss, _ = make_loss_fn(model)(params, b)
    loss.backward()
    torch.cuda.synchronize()
    assert ops.launches_by_route() == {"sm90": fwd["sm90"] + 2 * cfg.n_layers,
                                       "simt": fwd["simt"]}
    assert ops.launches_by_route(flash_attention_bwd) == {"sm90": bwd["sm90"] + cfg.n_layers,
                                                          "simt": bwd["simt"]}
    assert bool(torch.isfinite(loss.detach()))
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tree_leaves(params))


def test_zamba2_bf16_train_step_on_sm90(cuda_device):
    """One bf16 train step of Zamba2-2.7B at full width (d_model 2560, 32
    heads of 80), cut to 12 layers: two calls of the shared attention block,
    remat on.  Every flash forward (two a call under remat) and every
    backward (one a call) launches on the tensor-core route and none on
    SIMT; the loss and the gradient norm are finite."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.models import build
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.trainstep import TrainState, make_train_step

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12, name="zamba2-card-train")
    assert cfg.compute_dtype == "bfloat16" and cfg.remat and cfg.d_model == 2560
    assert (cfg.head_dim,) * 2 in ops.SM90_DK_DV
    n_attn = cfg.n_layers // cfg.attn_every
    model = build(cfg, device=cuda_device)
    params = model.init(0)
    state = TrainState(params, init_adamw(params))
    batch = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=512, global_batch=1)).batch_at(0)
    fwd, bwd = ops.launches_by_route(), ops.launches_by_route(flash_attention_bwd)
    state, m = make_train_step(model)(
        state, {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert n_attn == 2
    assert ops.launches_by_route() == {"sm90": fwd["sm90"] + 2 * n_attn, "simt": fwd["simt"]}
    assert ops.launches_by_route(flash_attention_bwd) == {"sm90": bwd["sm90"] + n_attn,
                                                          "simt": bwd["simt"]}
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))


# (B, Hq, Hkv, Sq, Skv, Dk, Dv): MLA's Dk = 192 > Dv = 128 (MHA, GQA with
# ragged Sq < Skv), Dk < Dv, and the widest Dk with a narrower Dv
MLA_BWD_CASES = [
    (1, 4, 4, 128, 128, 192, 128),
    (2, 8, 2, 100, 300, 192, 128),
    (1, 4, 2, 70, 90, 64, 128),
    (1, 2, 2, 65, 65, 256, 128),
]


@pytest.mark.parametrize("shape", MLA_BWD_CASES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_dk_ne_dv_matches_autograd(cuda_device, shape, causal, dtype):
    """The backward with Dk != Dv (MLA) under autograd, on the route the rule
    gives (bf16 at (192, 128) on the tensor cores, float32 and the other
    pairs on the SIMT kernel), against autograd through the float32 reference
    (``BWD_TOL``); a second launch on the same saved output and log-sum-exp
    gives the same bits and agrees with ``flash_attention_bwd_ref``."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops

    b, hq, hkv, sq, skv, dk, dv = shape
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    q = torch.randn(b, hq, sq, dk, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(b, hkv, skv, dk, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, skv, dv, generator=g, device=cuda_device).to(dtype)
    do = torch.randn(b, hq, sq, dv, generator=g, device=cuda_device).to(dtype)
    want = _autograd_want(q, k, v, do, causal)
    want_route = "sm90" if dtype == torch.bfloat16 and (dk, dv) in ops.SM90_DK_DV else "simt"
    assert ops.route(q, k, v) == ops.bwd_route(q, k, v, do) == want_route
    by_route = ops.launches_by_route(flash_attention_bwd)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    _, lse = ops._forward(q, k, v, causal, dk ** -0.5, with_lse=True)
    again = flash_attention_bwd(q, k, v, out.detach(), lse, do, causal=causal)
    plain = flash_attention_bwd_ref(q, k, v, out.detach(), lse, do, causal=causal)
    torch.cuda.synchronize()
    by_route[want_route] += 2
    assert ops.launches_by_route(flash_attention_bwd) == by_route
    rtol, atol = BWD_TOL[dtype]
    for name, x, y, p, w in zip("qkv", got, again, plain, want):
        assert x.dtype == dtype and x.shape == w.shape
        assert torch.equal(x, y), name
        for ref in (w, p):
            err = float((x.float() - ref.float()).abs().max())
            assert err <= rtol * float(ref.float().abs().max()) + atol, (name, err)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_train_steps_on_card_match_cpu(cuda_device, arch):
    """Three train steps of a reduced MoE model (DeepSeek-V3 with MLA and its
    MTP objective), float32 compute, on the card against the same steps on
    the CPU from the same parameters: every loss, aux, MTP loss and gradient
    norm within 1e-4 relative (summation order on the card; routing is the
    same on both); each step's attention backwards all on the SIMT kernel
    (float32, and MLA's Dk != Dv), one a layer (and one for the MTP block)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.flash_attention import flash_attention_bwd, ops
    from repro_torch.models import build
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.trainstep import TrainState, make_train_step

    cfg = get_config(arch).reduced(compute_dtype="float32", vocab=128,
                                   name=f"{arch}-card-train")
    host = params_to_numpy(build(cfg, device="cpu").init(0))
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2))
    n_attn = cfg.n_layers + (1 if cfg.mtp else 0)
    runs = []
    for device in ("cpu", cuda_device):
        model = build(cfg, device=device)
        params = params_from_numpy(host, device=device)
        state = TrainState(params, init_adamw(params))
        step = make_train_step(model)
        fwd, bwd = ops.launches_by_route(), ops.launches_by_route(flash_attention_bwd)
        metrics = []
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        if device != "cpu":
            torch.cuda.synchronize()
            assert ops.launches_by_route() == {"sm90": fwd["sm90"],
                                               "simt": fwd["simt"] + 3 * n_attn}
            assert ops.launches_by_route(flash_attention_bwd) == {
                "sm90": bwd["sm90"], "simt": bwd["simt"] + 3 * n_attn}
        runs.append(metrics)
    keys = {"loss", "aux", "grad_norm"} | ({"mtp"} if cfg.mtp else set())
    for cpu, card in zip(*runs):
        assert keys <= set(cpu) and set(cpu) == set(card)
        assert cpu["aux"] > 0
        for k in keys:
            assert abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]), (k, card[k], cpu[k])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_reduced_moe_model_on_card_matches_cpu(cuda_device, arch):
    """A reduced MoE model's forward (its aux loss too) and ``generate``, and
    DeepSeek-V3's ``lm_forward_mtp``, on the card against the same
    parameters on the CPU: float32 compute within 1e-4 relative, tokens
    equal; the forward's flash launches one a layer (MLA on the SIMT
    route), none in serving."""
    from repro_torch.configs.base import get_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build
    from repro_torch.models.transformer import lm_forward_mtp
    from repro_torch.serve import new_instance

    cfg = get_config(arch).reduced(compute_dtype="float32", name=f"{arch}-card-fwd")
    p_cpu = build(cfg, device="cpu").init(0)
    p_gpu = params_from_numpy(params_to_numpy(p_cpu), device=cuda_device)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    want, want_aux = build(cfg, device="cpu").forward(p_cpu, {"tokens": tokens})
    before = ops.launches_by_route()
    got, aux = build(cfg, device=cuda_device).forward(p_gpu, {"tokens": tokens.to(cuda_device)})
    torch.cuda.synchronize()
    assert ops.launches_by_route() == {"sm90": before["sm90"],
                                       "simt": before["simt"] + cfg.n_layers}
    assert float((got.cpu() - want).abs().max() / want.abs().max()) < 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-4 * float(want_aux)
    if cfg.mtp:
        _, w_mtp, _ = lm_forward_mtp(p_cpu, tokens, cfg)
        _, g_mtp, _ = lm_forward_mtp(p_gpu, tokens.to(cuda_device), cfg)
        assert float((g_mtp.cpu() - w_mtp).abs().max() / w_mtp.abs().max()) < 1e-4
    before = ops.launches_by_route()
    out_cpu = new_instance(cfg, p_cpu, 2, 48, device="cpu").generate(tokens[:, :32], 8)
    out_gpu = new_instance(cfg, p_gpu, 2, 48, device=cuda_device).generate(tokens[:, :32], 8)
    assert ops.launches_by_route() == before
    np.testing.assert_array_equal(out_gpu, out_cpu)


# --------------------------------------------------------------------------
# the VLM, xLSTM, Zamba2 and encoder-decoder families
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,want_route", [
    (4, 16, 16, 1, 160, 64, False, "sm90"),     # cross attention at decode: Sq = 1
    (2, 16, 16, 1, 1024, 64, False, "sm90"),
    (1, 16, 16, 300, 100, 64, False, "sm90"),   # cross attention, Sq > Skv
    (1, 16, 16, 100, 300, 64, False, "sm90"),   # Sq < Skv
    (1, 16, 16, 130, 130, 64, False, "sm90"),   # the encoder: Sq = Skv past a tile
    (1, 8, 8, 300, 300, 80, True, "sm90"),      # Zamba2's shared attention: D = 80
    (2, 8, 8, 77, 200, 80, False, "sm90"),
    (4, 32, 32, 1, 160, 80, False, "sm90"),     # D = 80, Sq = 1 over 160 keys
    (1, 8, 4, 130, 261, 80, True, "sm90"),      # D = 80, GQA 2:1, Skv past two tiles
])
def test_flash_kernel_at_the_families_shapes(cuda_device, b, hq, hkv, sq, skv, d, causal,
                                             want_route):
    """bf16 calls of the new families against the float32 reference on the
    upcast inputs, on their asserted routes, within one bf16 rounding."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, ops

    g = torch.Generator(device=cuda_device).manual_seed(sq * 13 + skv + d)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=cuda_device).to(torch.bfloat16)
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    assert ops.route(q, k, v) == want_route
    by_route = ops.launches_by_route()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launches_by_route() == {r: n + (r == want_route) for r, n in by_route.items()}
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    rtol, atol = FLASH_TOL[torch.bfloat16]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.allclose(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "xlstm-125m", "zamba2-2.7b",
                                  "seamless-m4t-medium"])
def test_reduced_family_model_on_card_matches_cpu(cuda_device, arch):
    """A reduced model of each new family on the card against the same
    parameters on the CPU, float32 compute: the forward (with vision embeds
    or frames) and a decode from the encoder's output within 1e-4 relative,
    ``generate`` token for token; its flash launches one a self-attention
    layer (the hybrid's shared block once a group) and one a cross attention,
    all on the SIMT route (float32), none in an xLSTM."""
    from repro_torch.configs.base import get_config
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import build, encdec
    from repro_torch.serve import new_instance

    cfg = get_config(arch).reduced(compute_dtype="float32", name=f"{arch}-card-fwd")
    m_cpu, m_gpu = build(cfg, device="cpu"), build(cfg, device=cuda_device)
    p_cpu = m_cpu.init(0)
    p_gpu = params_from_numpy(params_to_numpy(p_cpu), device=cuda_device)
    rng = np.random.default_rng(0)
    s = 64                                  # a multiple of the reduced SSD chunk (32)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, s)))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.vision_prefix, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, s, cfg.d_model)).astype(np.float32))
    want, _ = m_cpu.forward(p_cpu, batch)
    before = ops.launches_by_route()
    got, _ = m_gpu.forward(p_gpu, {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    if cfg.is_encdec:
        n_attn = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
    else:
        n_attn = cfg.n_layers if cfg.family == "vlm" else 0
    assert ops.launches_by_route() == {"sm90": before["sm90"], "simt": before["simt"] + n_attn}
    assert float((got.cpu() - want).abs().max() / want.abs().max()) < 1e-4
    if cfg.is_encdec:
        first = []
        for p, model, dev in ((p_cpu, m_cpu, "cpu"), (p_gpu, m_gpu, cuda_device)):
            enc = encdec.encode(p, batch["frames"].to(dev), cfg)
            c = model.init_caches(p, 2, 8, enc_out=enc)
            lg, _ = model.decode_step(p, {"tokens": batch["tokens"][:, :1].to(dev), "pos": 0}, c)
            first.append(lg.cpu())
        assert float((first[1] - first[0]).abs().max() / first[0].abs().max()) < 1e-4
    before = ops.launches_by_route()
    out_cpu = new_instance(cfg, p_cpu, 2, 48, device="cpu").generate(batch["tokens"][:, :32], 8)
    out_gpu = new_instance(cfg, p_gpu, 2, 48, device=cuda_device).generate(
        batch["tokens"][:, :32], 8)
    step = cfg.n_dec_layers if cfg.is_encdec else 0
    assert ops.launches_by_route() == {"sm90": before["sm90"],
                                       "simt": before["simt"] + step * 40}
    np.testing.assert_array_equal(out_gpu, out_cpu)


# ---------------------------------------------------------------------------
# sharding: the compressed all-reduce on NCCL, reshard onto a cuda mesh, the
# elastic-restore twin
# ---------------------------------------------------------------------------

def test_compressed_psum_on_a_one_rank_nccl_group(cuda_device):
    """On one rank the compressed all-reduce is quantize + dequantize, bit for
    bit, float32 and bf16; the group ``host_mesh`` started is gone after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import host_mesh
    from repro_torch.sharding.collectives import (compressed_psum, dequantize_int8,
                                                  quantize_int8)

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    with host_mesh(1, 1, device="cuda"):
        assert dist.get_backend() == "nccl"
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((1031, 77), generator=gen, device=cuda_device) * 3).to(dtype)
            out = compressed_psum(x)
            assert out.dtype == torch.float32 and out.device == x.device
            assert torch.equal(out, dequantize_int8(*quantize_int8(x)))
        zero = torch.zeros(64, device=cuda_device)
        assert torch.equal(compressed_psum(zero), zero)
    assert not dist.is_initialized()


def test_reshard_onto_a_cuda_mesh(cuda_device):
    """``reshard`` of a CPU state onto a (1, 1) ``cuda`` mesh: DTensors on the
    card whose local tensors ``==`` the input, laid out as ``named`` says."""
    from repro_torch.checkpoint.ckpt import reshard
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.models.model_zoo import build
    from repro_torch.sharding import partition
    from repro_torch.tree import tree_leaves

    params = build(get_config("qwen2.5-14b").reduced(vocab=512), device="cpu").init(0)
    specs = partition.param_specs(params)
    with host_mesh(1, 1, device="cuda") as mesh:
        placed = reshard(params, mesh, specs)
        want = partition.named(mesh, specs)
        for x, y, (name, lay) in zip(tree_leaves(params), tree_leaves(placed),
                                     sorted(_named_leaves(want))):
            local = y.to_local()
            assert local.device.type == "cuda" and tuple(y.placements) == lay, name
            assert torch.equal(local.cpu(), x), name


def _named_leaves(tree, path=""):
    """``(path, placements)`` of a tree of placements, in sorted-key order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _named_leaves(v, f"{path}/{i:06d}")]
    return [(path, tree)]


def test_elastic_restore_quick_on_the_card(cuda_device):
    """``scripts/elastic_restore.py --quick --device cuda``: both phases'
    losses finite, the re-sharded parameters bit-equal to the checkpointed
    ones on the card."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import elastic_restore

    from repro_torch.configs.base import get_config
    from repro_torch.tree import tree_leaves

    out = elastic_restore.run(get_config("xlstm-125m").reduced(vocab=512), 32, 4, 2,
                              device="cuda")
    assert out["reshard_bit_equal"]
    assert np.isfinite(out["losses1"] + out["losses2"]).all()
    assert all(p.to_local().device.type == "cuda" for p in tree_leaves(out["placed"]))
    assert elastic_restore.main(["--quick", "--device", "cuda"]) == 0
