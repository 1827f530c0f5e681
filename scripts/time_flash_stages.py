#!/usr/bin/env python3
"""Time the tensor-core flash forward built with 2 and with 3 K/V ring stages,
in turns on one NVIDIA card.

    python3 scripts/time_flash_stages.py [--seed 0] [--out FILE]

Copies ``flash_attention_sm90.cu`` and ``sm90_common.cuh`` of this checkout
into ``build/flash_stages/<n>/`` with ``kStages`` set to n, builds each with
the port's nvcc flags, and calls each library's C entry point on the same
bf16 inputs at Zamba2's shape (B=1, Hq=Hkv=32, S=4096, D=80, causal) and
OLMoE's (B=1, Hq=Hkv=16, S=4096, D=128, causal): both outputs must equal
the shipped wrapper's bit for bit, then CUDA-event times in the turns 2, 3,
3, 2, 2, 3.  One JSON line reports the card and the times.  Exits non-zero
without a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = {"zamba2": (1, 32, 32, 4096, 80), "olmoe": (1, 16, 16, 4096, 128)}
STAGES = (2, 3)


def build_variant(build, stages: int):
    """The forward library with ``stages`` K/V stages, its C entry point."""
    from repro_torch.kernels.flash_attention import kernel as fk

    src = build.KERNELS_DIR / "flash_attention" / "csrc"
    out_dir = ROOT / "build" / "flash_stages" / str(stages)
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "sm90_common.cuh", out_dir)
    text = (src / "flash_attention_sm90.cu").read_text()
    if "constexpr int kStages = 2;" not in text:
        raise AssertionError("flash_attention_sm90.cu no longer sets kStages = 2")
    (out_dir / "k.cu").write_text(text.replace("constexpr int kStages = 2;",
                                               f"constexpr int kStages = {stages};"))
    lib = out_dir / "k.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "k.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).aq_flash_attention_sm90
    fn.argtypes = list(fk._SM90_ARGS)
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("time_flash_stages: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops

    fns = {n: build_variant(build, n) for n in STAGES}
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    report = {"card": cs.card_line(), "order": "2, 3, 3, 2, 2, 3", "shapes": {}}
    for name, (b, hq, hkv, s, d) in SHAPES.items():
        q = torch.randn(b, hq, s, d, generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=g, device="cuda").to(torch.bfloat16)
        outs = {n: torch.empty_like(q) for n in STAGES}

        def run(n):
            rc = fns[n](q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[n].data_ptr(), None,
                        b, hq, hkv, s, s, d, d, *q.stride()[:3], *k.stride()[:3],
                        *v.stride()[:3], d ** -0.5, 1, build.stream_of(q))
            if rc != 0:
                raise RuntimeError(f"{n} stages: CUDA error {rc}")

        for n in STAGES:
            run(n)
        want = ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        if not all(torch.equal(outs[n], want) for n in STAGES):
            raise AssertionError(f"{name}: a variant's output differs from the wrapper's")
        turns = {n: [] for n in STAGES}
        for n in (2, 3, 3, 2, 2, 3):
            turns[n].append(cs.cuda_ms(lambda: run(n), iters=20))
        report["shapes"][name] = {"shape": [b, hq, hkv, s, d], "turns_ms": turns}
        del q, k, v, outs, want
    line = json.dumps(report)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
