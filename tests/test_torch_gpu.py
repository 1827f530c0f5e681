"""On the card: each CUDA kernel of the port against its plain torch version,
and the publish→restore slice at a small size.  Marked ``gpu``; they skip
where there is no card.  This file imports no JAX, so it runs on a machine
with PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.kernels import ChecksumMismatchError, FusedScatter, fused_publish, fused_restore
from repro_torch.kernels.snapshot_fuse.ref import fused_publish_ref, fused_restore_ref

PAGE = 4096
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


@pytest.mark.parametrize("n,zero_every", [(0, 3), (37, 3), (1000, 3), (64, 1), (64, 0)])
def test_publish_kernel_matches_plain(cuda_device, n, zero_every):
    pages, ws = _pages(n, n + 1, zero_every)
    p = torch.from_numpy(pages).to(cuda_device)
    w = torch.from_numpy(ws).to(cuda_device)
    before = fused_publish.launches
    got = fused_publish(p, w)
    torch.cuda.synchronize()
    for a, b in zip((got.zero_bitmap, got.checksums, got.hot, got.cold),
                    fused_publish_ref(p, w)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert fused_publish.launches == before + (1 if n else 0)


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
    assert fused_restore.launches == (math.ceil(regions.n_hot / 64)
                                      + reader.cold_runs().shape[0])
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
