"""The benchmark's tests: its harness at a tiny size on the CPU, and its
cells on the card (marked ``gpu``).  Run from the repository's root:

    PYTHONPATH=src python -m pytest -q aqbench/tests
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from aqbench import harness  # noqa: E402

TINY = {"image_pages": 2048, "cxl_capacity_bytes": 16 << 20, "rdma_capacity_bytes": 64 << 20}


def load_kept_config(name: str) -> dict:
    """A configuration kept in ``configs/`` for a later cell, which
    ``BENCHMARK.json`` does not name yet."""
    return json.loads((ROOT / "aqbench" / "configs" / f"{name}.json").read_text())


def tiny_cell(name: str, traffic: str = "") -> tuple:
    """``(cfg, mix)`` of a cell, cut to a size the CPU runs in a second:
    2,048 pages an image, 4 functions, 2 clients, 32 touches.  ``traffic``
    puts another mix on the cell's configuration.  A ``name`` that is no
    cell is a kept configuration, run with ``traffic``."""
    bench = harness.load_benchmark()
    if any(w["name"] == name for w in bench["workloads"]):
        cell = harness.find(bench, "workloads", name)
        cfg = harness.load_config(bench, cell["config"])
    else:
        cell, cfg = {"traffic": traffic}, load_kept_config(name)
    cfg = dict(cfg, functions=4, **TINY)
    mix = dict(harness.load_mix(traffic or cell["traffic"]), clients=2)
    if "touches" in mix:
        mix["touches"] = 32
    return cfg, mix


def run_tiny(name: str, seed: int = 2**31 + 77, control: str = "", trace: bool = False,
             seconds: float = 1.0, traffic: str = "") -> dict:
    cfg, mix = tiny_cell(name, traffic)
    return harness.run(name, cfg, mix, seed, seconds, trace, device="cpu", control=control)


@pytest.fixture
def card():
    """Skips a test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)
