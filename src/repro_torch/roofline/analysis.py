"""Roofline terms on one NVIDIA H100 (SXM, 80 GB HBM3).

    compute term = operations / peak rate of their type
    memory term  = bytes moved / HBM rate

The port's counterpart of ``repro/roofline/analysis.py``.  This module is
the one place that holds the card's roof: ``chip_smoke.py`` takes its
bounds from these constants, ``scripts/kernel_bench.py`` its modeled times
and the calibration that ``serve/strategies.py`` reads.

``movement_roofline``, ``RooflineTerms`` and ``model_flops_for`` are
ported.  ``parse_collective_bytes`` and ``analyze`` read the optimized XLA
HLO of a compiled dry run; they come with a torch FLOP and byte counter
(ROADMAP A12) and raise until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W limit
HBM_BW = 3.35e12          # bytes/s of HBM3
PEAK_FLOPS = 989e12       # bf16 on the tensor cores
PEAK_32BIT_OPS = 67e12    # float32 and int32 outside the tensor cores
# the snapshot sweeps do 32-bit integer work (poly32, zero tests): their
# compute term is taken at the 32-bit rate, as chip_smoke.bound_ms takes it
MOVEMENT_OPS_RATE = PEAK_32BIT_OPS

_A12 = ("reads the optimized XLA HLO of a compiled dry run: the torch FLOP and "
        "byte counter is not ported yet (ROADMAP A12)")


def parse_collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Collective operand bytes of an HLO module (reference
    ``analysis.parse_collective_bytes``)."""
    raise NotImplementedError(f"parse_collective_bytes {_A12}")


@dataclasses.dataclass
class RooflineTerms:
    """Per-device FLOP/byte/collective totals feeding the roofline model."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0       # 6·N·D (dense) or 6·N_active·D (MoE)
    xla_cost_analysis_flops: float = 0.0   # the reference's raw cost_analysis keys
    xla_cost_analysis_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def movement_roofline(name: str, bytes_read: float, bytes_written: float,
                      flops: float = 0.0, bw: float = HBM_BW) -> dict:
    """Roofline terms for a data-movement kernel (the snapshot data plane).

    The snapshot sweeps (zero scan, checksum, gather/scatter and their fused
    forms) do O(1) integer work per byte streamed, so they sit on the memory
    roof: the bound is the bytes read and written over ``bw``.
    ``scripts/kernel_bench.py`` feeds each op's per-invocation traffic
    through this helper for its modeled times and the per-page constants of
    ``experiments/torch/kernel_calibration.json``.  ``flops`` counts 32-bit
    operations, taken at :data:`MOVEMENT_OPS_RATE`.
    """
    total = float(bytes_read) + float(bytes_written)
    memory_s = total / bw
    compute_s = float(flops) / MOVEMENT_OPS_RATE
    bound_s = max(memory_s, compute_s)
    return {
        "name": name,
        "bytes_read": float(bytes_read),
        "bytes_written": float(bytes_written),
        "bytes_total": total,
        "flops": float(flops),
        "memory_s": memory_s,
        "compute_s": compute_s,
        "bound_s": bound_s,
        "bound_GBps": (total / bound_s / 1e9) if bound_s else 0.0,
        "dominant": "compute" if compute_s > memory_s else "memory",
    }


def analyze(compiled, chips: int, model_flops: float = 0.0,
            hlo_text: Optional[str] = None) -> RooflineTerms:
    """Roofline terms of a compiled dry run (reference ``analysis.analyze``)."""
    raise NotImplementedError(f"analyze {_A12}")


def model_flops_for(cfg, shape) -> float:
    """6·N·D training FLOPs (2·N·D for inference-only steps)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
