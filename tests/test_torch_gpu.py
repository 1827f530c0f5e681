"""On the card: each CUDA kernel of the port against its plain torch version,
the publish→restore slice and a reduced dense model at a small size.  Marked ``gpu``; they skip
where there is no card.  This file imports no JAX, so it runs on a machine
with PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

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
    route the rule gives it: bf16 with Dk == Dv in {64, 128} on the tensor
    cores, everything else on the SIMT kernel."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, ops

    g = torch.Generator(device=cuda_device).manual_seed(sq * 7 + dk)
    q = torch.randn(b, hq, sq, dk, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(b, hkv, skv, dk, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(b, hkv, skv, dv, generator=g, device=cuda_device).to(dtype)
    want_route = "sm90" if dtype == torch.bfloat16 and dk == dv and dk in (64, 128) else "simt"
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


@pytest.mark.parametrize("d", [64, 128])
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
