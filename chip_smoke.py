#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's publish→restore paths and its model on one
NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. card    — ``nvidia-smi`` name and power limit; no CUDA card is an error.
2. build   — compiles every CUDA kernel of the port from ``src/repro_torch``
             (one nvcc per source, all at once) into ``build/repro_torch_kernels``.
3. image   — a 1.5 GiB guest image (393,216 pages of 4 KiB, the paper's
             default instance) made on the card from ``--seed``: ~60% zero
             pages, ~5.5% hot pages in runs of mean ~5, the rest cold.
4. kernels — each of the six kernels against its plain torch version on the
             card, bit for bit (small, ragged, a partial fourth publish tile,
             all-zero, none-zero, all-0xFF cases; the full image for publish
             (its one-pass kernel's registers and spills read back by
             ``cuobjdump -res-usage``), zero_detect and
             page_checksum; the image's hot and cold sets for page_gather;
             one-segment restores and a forced checksum mismatch; rows past
             2^31 bytes of a 3 GiB arena for page_gather and page_scatter).
             The row-list forms of fused_restore and page_scatter at the
             private walks' shapes — the hot walk in 256-page chunks, the cold walk in guest
             runs, one segment an extent: verified installs, verify-only
             launches, three forced mismatches named exactly, the row
             scatter.  Then CUDA-event times of each kernel, its plain
             version and its library yardstick at the paths' shapes, beside
             the least time the card could take for the same work: the
             row-list kernels one launch a walk on a device-resident row list,
             and page_scatter's store write in
             turns with ``Tensor.index_copy_``.
5. main    — the private layout: ``HierarchicalPool`` →
             ``build_snapshot(publish_fn=fused)`` → ``SnapshotReader`` →
             ``Instance`` → ``RestoreEngine(FusedScatter)`` →
             ``pre_install_hot`` → ``install_all_sync``; the restored image
             must equal the source, every installed page must be verified,
             both walks must take the batched route, and both kernels'
             launch counts (reset just before) must match it: one publish,
             a verify-only launch and an install a walk.  Then the same
             snapshot restored on the batched and the per-extent route in
             turns (walls; routes asserted).
6. profile — the private path once more under ``torch.profiler``, the
             restore on both routes: device busy time by kernel and copy,
             and the idle share.
7. dedup   — a fleet of four variants of the image (shared base hot pages,
             a per-variant hot delta of round(n_hot*12/256) pages, a
             per-variant cold arena, shared zero pages) published into one
             content-addressed pool: variants 0 and 1 through the default
             kernels (zero_detect, page_gather, page_checksum as the store
             hash, page_scatter for store writes and restores), 2 and 3
             through the fused publish and the verified fused restore.  Store
             counts, refcounts (I6), the CXL estimate, every restore (all
             walks batched), the reconstruction of variant 3 and the launch
             counts of all six kernels (reset just before) must match the
             fleet's shape; variants 0 and 2 are restored again on both
             routes in turns; freeing the fleet must empty both stores.  One
             more variant is published and restored on both routes under
             ``torch.profiler``.

8. pod     — the pod's control plane at the same 1.5 GiB image:
             ``PoolMaster(publish_fn=fused).publish``; host a, a
             ``NodePageServer`` behind an ``Orchestrator``, attaches 8
             restores of the snapshot (one fan-out group) and each session's
             own thread pre-installs the hot set, installs the zero runs,
             starts the prefetcher and touches 1,024 cold pages in seeded
             order through ``access``; host b restores once through
             ``Orchestrator(prefetch_cold=True).restore`` beside them.  Once
             the nine borrows are out, an update (4,096 pages rewritten,
             driven through ``PoolMaster.publish_steps`` with a 1 ms poll)
             starts and must stay draining until the last
             ``RestoredInstance.shutdown``; version 1 is then restored on
             host b.  Every image bit-identical and every page verified, one
             CXL read per hot chunk for the group (7 fan-out hits each), two
             publish launches, every fused_restore launch accounted; delete and gc
             return the pool to its start, the servers park and no thread
             is left.  Prints time to hot and to full per instance, the
             fault-service latency of absent pages, the phase wall, the
             device idle share over a 3 s window under ``torch.profiler``
             once the nine borrows are out, and the peak memory.

9. topology — cell (6), the multi-pod topology at the same 1.5 GiB image:
             ``SimCluster(n_pods=3, ports_per_pod=2, schedule="round_robin",
             device="cuda")`` with I1–I8 checked after every step, arenas
             for two versions a pod, every pod master publishing through the
             fused sweep (``scripts/sim_scenarios.topology_cell``): a group
             publish of v0 to pods 0 and 1; an update to v1 (4,096 pages
             rewritten) racing 9 routed borrowers (3 homed on each pod, two
             attempts of 1,024 hot pages each) and a full restore on pod 0
             through ``FusedScatter``; a migration to pod 2 at 10x the
             break-even reads that retires the least-demanded source; a
             partition of pods 0 and 2 under a pod-0 borrower, which must
             read from pod 1, and its heal, after which a second pod-0
             borrower must read from pod 2; the loss of pod 1; a group
             delete.  Every borrowed page, the
             restore and the migrated replica bit-identical; local,
             inter-pod and fall-through routing all taken; every pod's free
             lists back to the start; launches exact: fused_publish 5 (one a
             pod a group write), fused_restore 2 + the image's cold runs.

10. sim    — every scenario of ``scripts/sim_scenarios.py`` (the single-pod
             and the multi-pod matrix at the tests' seeds, the drift and
             dedup sets at seed offsets 0–2, the dedup scenarios with
             ``page_checksum`` as the stores' hash), each run on the CPU and
             on the card in this process: traces, events, restored ledgers,
             catalogs, free lists and fault stats must be equal, and each of
             the six data-plane wrappers must have launched.

11. recurate — heat-driven re-curation at the same 1.5 GiB image: a
             ``PoolMaster`` with a ``HeatRegistry`` publishes it, two restores
             through ``Orchestrator`` touch the same seeded half of the hot
             set through ``touch_pages`` and the same 1,024 seeded cold pages
             through ``access``, ``PoolMaster.recurate_steps`` rebuilds
             version 1 (one fused publish launch; the plan it yields must
             promote the traced pages whose heat is >= 1 and demote exactly
             the untouched hot pages), version 1 restores bit-identically
             with every page verified; launch counts exact, delete and gc
             return every byte.

12. fleet   — fleet serving (``scripts/fleet_bench.py``, ``repro_torch.fleet``):
             (a) the bench twin's ``run`` and ``run_multipod`` at the
             reference's quick configurations (24 function types over 6
             base groups; the multi-pod tiers) with every pod on the card
             and every publish one fused launch, each output ``==`` the
             committed ``experiments/fleet_bench_quick.json`` /
             ``fleet_bench_multipod_quick.json`` key for key and every
             criterion true (the full configurations, 200 types and 189,870
             invocations: ``scripts/fleet_phase.py --full``); (b) the full
             configuration's fleet with each variant's pages x64 (16 MiB
             hot, 8 MiB cold, 4 MiB zero, 384 delta pages) from seeded
             generators on the card, published into one dedup pod, profiles
             exact against ``modeled_concurrent_restore_s`` at conc 1 and
             4, the 8 linspace variants restored verified and bit-identical
             to images made again from the seed, I6, the locality drive over
             the first quarter of the trace's 45 s (``FLEET_DRIVE_SHARE``,
             to keep the smoke in its budget with the moe and families
             phases; profiles
             extrapolated 16x to the bench's 256 MiB), then every
             variant deleted and every pool byte back;
             (c) the 1.5 GiB image published with ``compress_cold=True``:
             without ``zstandard`` the uncompressed publish, with it a
             compressed one restored verified.  Launch counts exact in each
             part; no thread left.  Prints p50 and p99 per policy and tier,
             the keys compared, each step's wall, the publish wall per
             variant and the host decision share, and the peak memory.

13. benches — the paper's evaluation benches on the port: (a) the twins
             ``scripts/{dedup,fault,adaptive,concurrency}_bench.py`` at the
             reference's full configurations, ``scripts/breakdown.py`` (chameleon, 32
             concurrent), ``scripts/serving_bench.py`` (the nine workloads),
             the paper's Fig. 3, 4 and 7 (``scripts/{characterization,
             runlength,scalability}.py``, the nine images built once for all
             four) and ``scripts/kernel_bench.py`` (the six wrappers timed at
             8,192 pages), every pool on the card and every publish one
             fused launch, each output held to its committed CPU output in
             ``experiments/torch/`` (``breakdown`` also to
             ``experiments/breakdown.json``): integers, booleans and strings
             ``==``, floats ``==`` or within 1e-12 relative
             (``model_err_max``, a relative error, within 1e-12), every key
             but the wall clocks, the brownout's breaker rejections
             (which follow the wall clock) and kernel_bench's measured
             section and backend (the device's times and name); every
             criterion true; each wrapper's
             launches as ``BENCH_LAUNCHES`` says, flash attention's 0.  (b)
             the fault bench's bare run and four sweeps, ``FAULT_RESTORES``
             restore each (cut from two to keep the smoke in its budget),
             at the 1.5 GiB image through its own ``make_stack`` /
             ``run_sweep``: every restore bit-identical and every page
             verified, armed-but-empty ledgers equal to the bare ones,
             retries, one repair a poisoned restore, every brownout restore
             degraded within 15% of the all-cold model, every pool byte
             back; launches as ``fault_cell_launches`` says.  Prints each
             twin's wall and headline (capacity multiplier, p50s, recovery,
             concurrency gain, speedups), each restore's wall and the peak
             memory.

14. coldstart — Phi-4-mini 3.8B's serverless cold start from the pool at
             full width, cut to ``COLDSTART_LAYERS`` (4) of its 32 layers to
             keep the smoke in its budget (at full depth 17.8 GB, ~4.35 M pages),
             float32 weights from the seed: reference tokens from the
             original parameters
             (4 prompts of 16 tokens, 8 new tokens); the working set from 16
             profiled invocations of the compression workload's shape (every
             array whole, the token table's Zipf(1.4) prompt rows only);
             ``save_checkpoint`` into a pool sized to the composition (one
             fused publish); the five restore strategies, modeled; the
             publish's zero flags and checksums and a ``zero_page_bitmap``
             launch held against the plain versions at the full image; a
             ``SkeletonPool`` claim; ``restore_server`` through an
             ``Orchestrator`` that prefetches the cold tail (batched hot walk,
             a fused_restore launch a cold extent); the restored server
             serving the same tokens; a second restore under torch.profiler
             (device activity) for the idle share; every restored array
             bit-equal to the parameters regenerated from the seed; the
             skeleton pool closed, no thread left, delete and gc.  Prints
             time to hot and to full, the publish, claim, prefill and decode
             walls, the modeled ledger and the peak device memory.

15. model   — flash attention against its plain versions on the card, each
             case on the route ``ops.route`` gives it and asserted so: bf16
             with (Dk, Dv) in ``ops.SM90_DK_DV`` on the tensor-core kernel
             (``flash_attention_sm90.cu``), float32 and other pairs on the
             SIMT kernel (``flash_attention.cu``); the prefill path's shape B=1,
             Hq=24, Hkv=8, S=8192, D=128, causal, one tile, keys not a
             multiple of 128, ragged Sq < Skv and non-causal cases; bf16
             within one rounding of the float32 reference on the upcast
             inputs, 2^-8|want| + 1e-4, float32 within 1e-5.  At the prefill
             shape, in turns in one call, the tensor-core kernel, the SIMT
             kernel on the same bf16 inputs and ``scaled_dot_product_attention``,
             beside the plain version and the bound; whether the library's
             SASS holds HGMMA and UTMALDG.  Then Phi-4-mini 3.8B at full width
             from seeded random weights: ``build(...).forward`` over one
             8,192-token sequence with all 32 layers (32 launches, all on the
             tensor-core route, finite logits), the
             serving engine answering 4 requests of 128-token prompts with 32
             new tokens each through ``generate`` (decode attention, no
             kernel launch), the full-depth bf16 forward's last logits against
             the engine's prefill logits (printed), and decode against forward
             at full width, 2 layers, float32 (relative error < 2e-3).  One
             prefill forward and four decode steps run under torch.profiler.

16. moe     — the MoE family.  The flash forward at its two full-width
             prefill shapes, each on its asserted route, against its float32
             plain version on the upcast inputs (the model phase's limits):
             OLMoE's B=1, Hq=Hkv=16, S=4096, D=128 and MLA's B=1,
             Hq=Hkv=128, S=4096, Dk=192, Dv=128, both bf16 on the tensor-core
             kernel, each timed in turns with ``scaled_dot_product_attention``
             (which takes Dk != Dv too); the backward with Dk != Dv (float32
             and Dk < Dv on SIMT, bf16 at (192, 128) on the tensor cores;
             causal and not, ragged, GQA, and MLA's shape at S=2048) against
             autograd and its plain version within the train phase's limits,
             two launches bit-equal, and its time beside the library's (the
             SIMT kernels' times at MLA's shape are PERF.md's record, not
             retimed); registers, spills and HGMMA counts of both tensor-core
             libraries' (192, 128) kernels (``cuobjdump``), no spill.  Cell
             (10): OLMoE-1B-7B at full width and depth (6.92 B float32
             parameters from the seed): one 4,096-token ``Model.forward``
             (16 flash launches, all sm90), 4 requests of 128 + 32 tokens
             through ``generate`` at capacity factor 1.25 (decode drops tokens
             by design; its prefill and decode walls taken apart), a profiled
             forward and four decode steps, and float32
             decode against forward on 2 layers at the no-drop capacity
             (< 2e-3).  Cell (11): DeepSeek-V3 at full width on 2 layers (one
             dense, one MoE; bf16 parameters) with its MTP head: float32 decode
             against forward at the no-drop capacity first (< 2e-3; that model
             freed), one 4,096-token ``lm_forward_mtp`` (3 flash launches, all
             sm90), 4 requests of 128 + 16 tokens with ``mla_absorb`` off and
             on (tokens printed).  The recognition workload's image built on
             the card, published with the fused sweep and restored
             bit-identically, every page verified, its zero/hot/cold shares
             equal to the CPU run's.  Launch counts exact for every path.

17. families — the VLM, xLSTM, Zamba2 and encoder-decoder families.  The
             flash forward at their new shapes, each on its asserted route,
             against its float32 plain version on the upcast inputs (the
             model phase's limits) and timed in turns with
             ``scaled_dot_product_attention``: Qwen2-VL's B=1, Hq=64, Hkv=8,
             S=4096, D=128 causal, SeamlessM4T's 16 heads, S=1024, D=64
             non-causal and its served cross attention at decode (B=4,
             Sq=1, Skv=160, D=64 non-causal) and Zamba2's Hq=Hkv=32,
             S=4096, D=80 causal on the tensor cores, the SIMT kernel also
             timed in those turns at Zamba2's shape.  The backward at
             (80, 80) (bf16 on the tensor cores: Zamba2's shape, GQA with
             ragged Sq < Skv, non-causal; float32 and a dO view no TMA map
             takes on SIMT) against autograd and its plain version within
             the train phase's limits, two launches bit-equal, and at
             Zamba2's shape in turns with the SIMT kernel, the plain version
             and the library's backward; registers, spills and HGMMA counts
             of both tensor-core libraries' (80, 80) kernels, no spill.
             Four cells from seeded random
             weights, each freed before the next (device memory back to its
             start, asserted): Qwen2-VL-72B at full width cut to 8 of 80
             layers in bf16 (a 4,096-token forward with 256 seeded vision
             embeds, 8 sm90 launches), Zamba2-2.7B at full size (54 Mamba2
             blocks and the shared attention block before each group of 6: a
             4,096-token forward, 9 sm90 launches), xLSTM-125M at full size
             (a 2,048-token forward, no flash), SeamlessM4T-medium at full
             size (1,024 frames and 1,024 tokens, 36 sm90 launches; 12 a
             decode step, the cross attention at Sq = 1): each forward's
             logits finite, 4 requests of 128 + 32 tokens through the
             serving engine (prefill and decode timed apart), a profiled
             forward and four decode steps, and float32 decode against
             forward (< 2e-3: Qwen2-VL on 2 layers over its 256-patch
             prefix and 16 text tokens, vision embeds the token embeddings;
             SeamlessM4T from its encoder's cross K/V; 64 tokens).  The
             image, pyaes, pagerank and ffmpeg workloads' images built on
             the card (zero/hot/cold shares and working sets equal to the
             CPU run's), each published by one fused launch and restored
             bit-identically, every page verified.  Launch counts exact for
             every path.

18. train   — training on the card.  (a) The flash-attention backward on
             both routes (``flash_attention_bwd_sm90.cu``: TMA, wgmma;
             ``flash_attention_bwd.cu``: SIMT) against autograd through the
             float32 reference on the upcast inputs (float32 within 1e-4
             max|want| + 1e-6, bf16 within 2^-6 max|want| + 1e-4, per
             gradient) and against its plain version on the same saved output
             and log-sum-exp, each case's forward and backward on their
             asserted routes: the training shape B=1, Hq=24, Hkv=8, S=4096,
             D=128 causal in bf16 (sm90; and SIMT, through a dO view whose
             rows no TMA map takes) and float32, D=64, S=1000, ragged
             Sq < Skv, non-causal, MHA; two launches bit-equal; the library's
             bf16 backward's share of the same limit; at the training shape,
             in turns, the tensor-core kernel, the SIMT kernel, the plain
             backward and ``scaled_dot_product_attention``'s backward beside
             the bound.  (b) Phi-4-mini 3.8B at full width, 3 of its 32
             layers (1.53 B float32 parameters, bf16 compute, remat), batches
             of ``SyntheticLMData(vocab=200064, seq_len=4096, global_batch=1)``:
             6 uninterrupted steps (one more under torch.profiler for the
             backward's share of the device time); a ``Trainer`` that runs 3
             steps with a blocking checkpoint (one fused publish) and is
             dropped; a second ``Trainer`` that resumes through
             ``run(resume=True)`` and trains to step 6.  The restored state
             equal to the checkpointed one, every page verified, every loss
             and gradient norm finite, the resumed parameters equal to the
             uninterrupted run's, launches exact (forward twice a layer a
             step under remat, the backward once, every one on sm90).  (c) The quickstart twin
             (``scripts/quickstart.py``) with asynchronous checkpoints: its
             loss falls, the restored parameters bit-identical, 12 tokens.
19. sharding — (a) ``compressed_psum`` over every gradient leaf of
             xLSTM-125M at full width (12 blocks, d_model 768, vocab 50,304)
             on a one-rank NCCL group, each bit-equal to quantize +
             dequantize; (b) the elastic-restore twin
             (``scripts/elastic_restore.py``) on that model at seq 64, batch
             8, 5 + 5 steps: publish (one fused publish), restore through the
             fused restore, ``reshard`` onto a (1, 1) cuda mesh, train on;
             the re-sharded parameters bit-equal to the checkpointed ones on
             cuda:0, every page verified, every loss finite, launches exact
             (no attention: xLSTM has none); (c) the dry run's Phi-4-mini
             ``decode_32k`` cell in a subprocess on 256 fake ranks, status
             ok, its roofline terms printed.  Alone:
             ``scripts/sharding_phase.py``.

Prints each phase's wall time, a ``{"kernels": [...]}`` line, the card line,
and as the last line ``{"ok": true, "device": {...}}``.  Details go to
``--out``.  Modeled ledger seconds are the paper's CXL/RDMA cost model, not
device times.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))      # sim_scenarios: the simulator's scenarios

PAGE = 4096
PAPER_INSTANCE_PAGES = (3 << 29) // PAGE       # 1.5 GiB (paper §2.3.3)
# the card's roof (the H100 SXM data sheet's rates), from its one source
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S,
    PEAK_32BIT_OPS as F32_FLOPS_PER_S,
    PEAK_32BIT_OPS as INT32_OPS_PER_S,
    PEAK_FLOPS as BF16_FLOPS_PER_S,
)

PUBLISH_TPU = "src/repro/kernels/snapshot_fuse/kernel.py:94"
RESTORE_TPU = "src/repro/kernels/snapshot_fuse/kernel.py:146"
CSRC = "src/repro_torch/kernels/snapshot_fuse/csrc"
ROW_KERNELS = {   # name -> the TPU kernel it replaces
    "zero_detect": "src/repro/kernels/zero_detect/kernel.py:26",
    "page_checksum": "src/repro/kernels/page_checksum/kernel.py:22",
    "page_gather": "src/repro/kernels/page_gather/kernel.py:26",
    "page_scatter": "src/repro/kernels/page_scatter/kernel.py:25",
}
ARENA_BYTES = 3 << 30          # the dedup pool's RDMA arena: rows pass 2^31 bytes
N_VARIANTS = 4
POD_SESSIONS = 8     # co-located restores on host a: concurrency_bench.py's level 8
POD_TOUCHES = 1024   # guest touches an instance makes, cold pages in seeded order
POD_DELTA = 4096     # non-zero pages the update rewrites
POD_PROFILE_S = 3.0  # the profiled window of the group restore, once all borrows are out
TOPO_READ_PAGES = 1024   # hot pages each routed borrower reads and verifies an attempt
DATA_PLANE = ("fused_publish", "fused_restore", *ROW_KERNELS)
MODEL_ARCH = "phi4-mini-3.8b"
RECURATE_TOUCHES = 1024     # seeded cold pages each of the two re-curation restores touches
COLDSTART_NAME = "phi4-mini"
COLDSTART_INVOCATIONS = 16  # the paper's replay count (§3.2)
COLDSTART_PROMPT = 96       # the compression workload's prompt (benchmarks/workloads.py:55)
COLDSTART_COMPUTE_S = 0.25  # and its modeled compute
COLDSTART_CONC = 32         # co-located restores in examples/serve_coldstart.py
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 16, 8   # the cold-started server's requests
PREFILL_SEQ = 8192          # prefill_32k cut to one 8,192-token sequence
TRAIN_SEQ = 4096            # train_4k's sequence length (configs/shapes.py)
COLDSTART_LAYERS = 4        # the cold start's Phi-4-mini cut to 4 of 32 layers in the smoke
FAULT_RESTORES = 1          # benches (b): restores a fault sweep in the smoke
TRAIN_LAYERS = 3            # Phi-4-mini's 32 layers cut to 3: the checkpoint's peak is 4x the state
TRAIN_STEPS = 6
TRAIN_CKPT_STEP = 3
FLEET_SCALE_X = 64          # fleet (b): pages a variant over the bench's full configuration
FLEET_DRIVE_SHARE = 0.25    # fleet (b): the locality drive over this share of the trace's span
MOE_SEQ = 4096              # OLMoE's context length: the MoE cells' one-sequence forward
MOE_SERVE = (4, 128, 32)    # OLMoE serving: requests, prompt tokens, new tokens
MLA_SERVE = (4, 128, 16)    # DeepSeek-V3 serving, with mla_absorb off and on
MLA_BWD_SEQ = 2048          # the Dk != Dv backward's check at MLA's width
DSV3_CUT = dict(n_layers=2, n_dense_layers=1, param_dtype="bfloat16")   # cell (11)'s cuts
FAMILY_SERVE = (4, 128, 32)  # each family cell's serving: requests, prompt tokens, new tokens
# the family cells: the forward's tokens (4,096; xLSTM 2,048, its paper's context), the
# cut (Qwen2-VL's 80 layers are 145 GB even in bf16), how many forwards, the float32 parity's
# tokens (past the VLM's 256-patch prefix) and cut, and the cell's generator seed offset
FAMILY_CELLS = {
    "qwen2-vl-72b": {"seq": 4096, "cut": {"n_layers": 8, "param_dtype": "bfloat16"},
                     "forwards": 2, "parity_seq": 272, "parity_cut": {"n_layers": 2},
                     "seed": 61},
    "zamba2-2.7b": {"seq": 4096, "forwards": 2, "parity_seq": 64, "seed": 67},
    "xlstm-125m": {"seq": 2048, "forwards": 1, "parity_seq": 64, "seed": 71},
    "seamless-m4t-medium": {"seq": 1024, "forwards": 2, "parity_seq": 64, "seed": 73},
}
# the flash forward's new shapes, (B, Hq, Hkv, Sq, Skv, Dk, Dv): Qwen2-VL's GQA 64:8, Zamba2's
# D = 80 (its SIMT kernel's time taken in the same turns, FAMILY_SIMT_TIMED), SeamlessM4T's
# non-causal encoder, and its served cross attention at decode (batch 4, one query row of a
# 128-row tile, over the 128 + 32 = 160 cross keys that the engine's caches hold for
# FAMILY_SERVE's requests)
FAMILY_FLASH_SHAPES = {"qwen2-vl": ((1, 64, 8, 4096, 4096, 128, 128), True, "sm90"),
                       "zamba2": ((1, 32, 32, 4096, 4096, 80, 80), True, "sm90"),
                       "seamless": ((1, 16, 16, 1024, 1024, 64, 64), False, "sm90"),
                       "seamless_decode": ((FAMILY_SERVE[0], 16, 16, 1, sum(FAMILY_SERVE[1:]),
                                            64, 64), False, "sm90")}
FAMILY_SIMT_TIMED = ("zamba2",)
FAMILY_WORKLOADS = ("image", "pyaes", "pagerank", "ffmpeg")
# the evaluation benches' twins (scripts/<name>.py), in the order the benches phase runs them
BENCHES = ("dedup_bench", "fault_bench", "adaptive_bench", "concurrency_bench", "breakdown",
           "serving_bench", "characterization", "runlength", "scalability", "kernel_bench")
# the twins with one configuration: the smoke and the card tests run it whatever ``quick`` says
SINGLE_CONFIG = ("breakdown", "serving_bench", "characterization", "runlength", "scalability",
                 "kernel_bench")
# Launches of each data-plane wrapper in one run of each twin on the card, at its full and quick
# configurations (a wrapper not named: 0), worked out from the code; the bench tests hold the
# CPU tally of the same runs to these numbers (tests/test_torch_bench_harness.py).
BENCH_LAUNCHES = {
    # one fused sweep a publish (2 pods x 24 variants) and a capacity demotion (the baseline's
    # 17); a budgeted publish's admission estimate: a zero scan, and on the dedup pod a hot
    # gather; two store writes a dedup publish; one launch a non-empty batched walk of a restore
    "dedup_bench": {"full": {"fused_publish": 65, "zero_detect": 48, "page_gather": 24,
                             "page_scatter": 127},
                    "quick": {"fused_publish": 23, "zero_detect": 16, "page_gather": 8,
                              "page_scatter": 41}},
    # a sweep a stack (bare, four sweeps, the model); per restore: bare 4 (two batched walks,
    # a verify-only launch and an install each); armed, per extent: a hot chunk + a cold run
    # (none, timeouts), 2 more for the poisoned page, a demand fault a hot page (brownout)
    "fault_bench": {"full": {"fused_publish": 6, "fused_restore": 8608},
                    "quick": {"fused_publish": 6, "fused_restore": 616}},
    # publishes: drift 1 + its re-curation 1, prefetch A/B 1 a seed, capacity 4 + 2
    # demotions; a zero scan a budgeted capacity publish; batched walks, prefetched extents
    # and demand faults install through page_scatter
    "adaptive_bench": {"full": {"fused_publish": 12, "zero_detect": 4, "page_scatter": 3352},
                       "quick": {"fused_publish": 9, "zero_detect": 4, "page_scatter": 733}},
    # a publish a snapshot of each point (12 same, 30 mixed); a restore's hot walk and each
    # installed cold extent through page_scatter
    "concurrency_bench": {"full": {"fused_publish": 42, "page_scatter": 4056},
                          "quick": {"fused_publish": 4, "page_scatter": 468}},
    # a zero scan a modeled strategy (5, per-page aquifer, 2 hot pre-install models); the
    # restore's hot walk and 898 prefetched extents
    "breakdown": {"full": {"fused_publish": 1, "zero_detect": 8, "page_scatter": 899}},
    # one publish a workload (nine); the batched restore's two walks (the per-page one copies
    # page by page)
    "serving_bench": {"full": {"fused_publish": 9, "page_scatter": 18}},
    # a zero scan a workload's classification, and one of its first 4,096 pages against the
    # host's bitmap
    "characterization": {"full": {"zero_detect": 18}},
    # a zero scan a workload's classification
    "runlength": {"full": {"zero_detect": 9}},
    # a zero scan a modeled run: 9 workloads x (6 strategies x 8 concurrencies + 2 hot
    # pre-install models)
    "scalability": {"full": {"zero_detect": 450}},
    # each timed call (first, warm, reps: 5 full, 2 quick) of the four wrappers and of the two
    # pairs (piecemeal publish: a zero scan, 3 checksums, 2 gathers; piecemeal restore: a
    # gather, a checksum, a scatter), one more of each pair for bit-identity, the calls that
    # find the hot set and the chunk, and the 3-page publish's timed calls
    "kernel_bench": {"full": {"fused_publish": 15, "fused_restore": 8, "zero_detect": 16,
                              "page_checksum": 39, "page_gather": 32, "page_scatter": 15},
                     "quick": {"fused_publish": 9, "fused_restore": 5, "zero_detect": 10,
                               "page_checksum": 24, "page_gather": 20, "page_scatter": 9}},
}
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:91"
FLASH_CSRC = "src/repro_torch/kernels/flash_attention/csrc"
FLASH_SRC = {"bwd": f"{FLASH_CSRC}/flash_attention_bwd.cu",
             "bwd_sm90": f"{FLASH_CSRC}/flash_attention_bwd_sm90.cu",
             "sm90": f"{FLASH_CSRC}/flash_attention_sm90.cu",
             "simt": f"{FLASH_CSRC}/flash_attention.cu"}
# the tensor-core libraries' (Dk, Dv) instantiations as their mangled names
# spell them: (64, 64), Zamba2's (80, 80), (128, 128) and MLA's (192, 128)
SM90_PAIRS = ("ILi64ELi64E", "ILi80ELi80E", "ILi128ELi128E", "ILi192ELi128E")
SM90_MLA, SM90_D80 = SM90_PAIRS[3], SM90_PAIRS[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, int_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs) -> int:
    errs = [0]
    for a, b in pairs:
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.numel():
            errs.append(int((a.to(b.dtype).long() - b.long()).abs().max()))
    return max(errs)


def data_plane_wrappers() -> dict:
    """The six data-plane kernel wrappers by name (their ``launches`` counts)."""
    from repro_torch import kernels as kmod

    return {name: getattr(kmod, name) for name in DATA_PLANE}


def make_image(n_pages: int, seed: int, device):
    """Guest image on the card: alternating zero / cold regions (geometric
    lengths, means 96 and 55 pages) with hot runs (geometric, mean 5 pages,
    5.5% of the pages) laid over them; non-zero pages hold random bytes."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n_reg = int(n_pages / (96 + 55) * 1.5) + 64
    lens = torch.empty(2 * n_reg, device=device)
    lens[0::2].geometric_(1 / 96, generator=g)
    lens[1::2].geometric_(1 / 55, generator=g)
    bounds = torch.cumsum(lens.long(), 0)
    if int(bounds[-1]) < n_pages:
        raise RuntimeError("region draw too short for the image")
    pages = torch.arange(n_pages, device=device)
    zero_region = torch.searchsorted(bounds, pages, right=True) % 2 == 0
    n_hot_runs = round(0.057 * n_pages / 5)    # overlaps merge: ~5.5% hot
    starts = torch.randint(0, n_pages, (n_hot_runs,), generator=g, device=device)
    run_len = torch.empty(n_hot_runs, device=device).geometric_(1 / 5, generator=g).long()
    delta = torch.zeros(n_pages + 1, dtype=torch.long, device=device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, (starts + run_len).clamp(max=n_pages), -torch.ones_like(starts))
    hot = torch.cumsum(delta, 0)[:n_pages] > 0
    buf = torch.randint(0, 256, (n_pages * PAGE,), dtype=torch.uint8, generator=g,
                        device=device)
    buf.view(n_pages, PAGE)[zero_region & ~hot] = 0
    return buf, hot


def check_publish(torch, ops, ref, cases):
    """Kernel vs plain publish, bit for bit, for each (name, pages, ws)."""
    err = 0
    for name, pages, ws in cases:
        got = ops.fused_publish(pages, ws)
        want = ref.fused_publish_ref(pages, ws)
        torch.cuda.synchronize()
        outs = (got.zero_bitmap, got.checksums, got.hot, got.cold)
        for field, a, b in zip(("zero", "csum", "hot", "cold"), outs, want):
            if not torch.equal(a, b):
                raise AssertionError(f"fused_publish differs from plain ({name}, {field})")
        err = max(err, max_abs_err(zip(outs, want)))
        log(f"  publish {name}: n={pages.shape[0]} hot={got.hot.shape[0]} "
            f"cold={got.cold.shape[0]} bit-equal")
    return err


def publish_bound(n: int, nnz: int):
    """The publish sweep's bound ``(ms, by, bytes)`` at ``n`` pages of which
    ``nnz`` are non-zero: the pages read once, the non-zero pages written
    once, 6 bytes a page of flags and checksums, the weights and the counts."""
    nbytes = n * PAGE + n + PAGE + n + 4 * n + nnz * PAGE + 8
    return (*bound_ms(nbytes, 3 * n * (PAGE // 4)), nbytes)


def restore_rows_bytes(m: int, op: str = "install") -> int:
    """Bytes a row-list launch of ``m`` rows moves: each row read (and, but
    for a verify-only launch, written) once, its 16-byte address and
    destination, its expected and computed checksums and its bad flag, and
    the mismatch count; a scatter moves rows and addresses only."""
    if op == "scatter":
        return m * (2 * PAGE + 16)
    return m * ((PAGE if op == "verify_only" else 2 * PAGE) + 16 + 4 + 4 + 1) + 4


def time_publish(torch, ops, ref, pm, ws, nnz: int) -> dict:
    """The publish kernel's own time (memset and kernel, launched back to
    back on preallocated outputs), the wrapper's (the working set's size read
    before the launch, the counts after), the plain version's, and the bound
    (``publish_bound``)."""
    from repro_torch.kernels.page_checksum.ops import weights_on
    from repro_torch.kernels.snapshot_fuse import kernel

    n = pm.shape[0]
    n_ws = int(ws.sum())
    t = ops.PUBLISH_TILE_PAGES
    zero = torch.empty(n, dtype=torch.bool, device=pm.device)
    csum = torch.empty(n, dtype=torch.int32, device=pm.device)
    out, counts = torch.empty_like(pm), torch.empty(2, dtype=torch.int32, device=pm.device)
    scratch = torch.empty(1 + -(-n // t), dtype=torch.int64, device=pm.device)
    w = weights_on(pm.device, PAGE // 4)

    def launch():
        kernel.publish(pm, ws, w, n_ws, t, zero, csum, out, counts, scratch)

    ms = cuda_ms(launch, iters=20)
    del out
    bound, by, nbytes = publish_bound(n, nnz)
    return {"ms": ms, "wrapper_ms": cuda_ms(lambda: ops.fused_publish(pm, ws), iters=10),
            "plain_ms": cuda_ms(lambda: ref.fused_publish_ref(pm, ws), iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes, "tile_pages": t}


def check_restore(torch, np, ops, ref, dest_rows: int, device):
    """Kernel vs plain restore, bit for bit; a forced mismatch must raise."""
    rng = np.random.default_rng(11)
    err = 0
    for m in (1, 37, 256):
        chunk = torch.randint(0, 256, (m, PAGE), dtype=torch.uint8, device=device)
        chunk[0] = 0xFF                                   # all-ones lanes
        dst = np.sort(rng.choice(dest_rows, m, replace=False))
        src = rng.permutation(m)
        dest_k = torch.zeros((dest_rows, PAGE), dtype=torch.uint8, device=device)
        dest_p = torch.zeros_like(dest_k)
        _, cs = ops.fused_restore(dest_k, chunk, dst, src_indices=src)
        want = ref.fused_restore_ref(dest_p, chunk, torch.from_numpy(src).to(device),
                                     torch.from_numpy(dst).to(device))
        torch.cuda.synchronize()
        if not (torch.equal(dest_k, dest_p) and torch.equal(cs, want)):
            raise AssertionError(f"fused_restore differs from plain (m={m})")
        err = max(err, max_abs_err([(cs, want)]))
        table = torch.zeros(dest_rows, dtype=torch.int32, device=device)
        table[torch.from_numpy(dst).to(device)] = want
        ops.fused_restore(dest_k, chunk, dst, src_indices=src, expected_table=table)
        bad = dst[[0, m - 1]] if m > 1 else dst[:1]
        table[torch.from_numpy(bad).to(device)] ^= 1
        try:
            ops.fused_restore(dest_k, chunk, dst, src_indices=src, expected_table=table)
        except ops.ChecksumMismatchError as e:
            if sorted(e.bad_pages.tolist()) != sorted(set(bad.tolist())):
                raise AssertionError(f"mismatch names {e.bad_pages}, want {bad}") from e
        else:
            raise AssertionError("a forced checksum mismatch did not raise")
        del dest_k, dest_p
        log(f"  restore m={m}: bit-equal, verified, mismatch raised")
    return err


def profile_by_name(torch, prof) -> tuple:
    """The profiler's raw events (``kineto_results``) summed by name:
    ``({kernel, copy or memset: [count, device ms]}, {host op or runtime
    call: [count, ms]})``, host times inclusive of the calls an op makes.
    ``key_averages()`` first builds a Python tree of every event, about
    0.5 ms an event on the card's host (two minutes for the xLSTM forward's
    ~260 k launches); this reads each event once."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = {}, {}
    for e in prof.profiler.kineto_results.events():
        row = (dev if e.device_type() == cuda else host).setdefault(e.name(), [0, 0.0])
        row[0] += 1
        row[1] += e.duration_ns() / 1e6
    return dev, host


def _device_summary(torch, prof, wall_s: float, top: int = 8, table: Path = None) -> dict:
    """Device busy time (the sum of kernel, copy and memset times), its idle
    share of ``wall_s``, the top device entries and host ops by name;
    ``table``: where to write the top 25 of each as text."""
    dev, host = profile_by_name(torch, prof)
    rows = sorted(dev.items(), key=lambda kv: -kv[1][1])
    hrows = sorted(host.items(), key=lambda kv: -kv[1][1])
    busy_ms = sum(ms for _, ms in dev.values())
    if table is not None:
        table.write_text("device ms  count  kernel / copy\n" + "".join(
            f"{ms:10.3f} {n:6d}  {k}\n" for k, (n, ms) in rows[:25])
            + "\nhost ms (inclusive)  count  op / call\n" + "".join(
            f"{ms:10.3f} {n:6d}  {k}\n" for k, (n, ms) in hrows[:25]))
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "top": [{"name": k, "count": n, "device_ms": ms} for k, (n, ms) in rows[:top]],
            "host_top": [{"name": k, "count": n, "cpu_ms": ms} for k, (n, ms) in hrows[:top]]}


def profile_main_path(torch, pool, image, working_set, ops, out_dir: Path) -> dict:
    """Publish once more, then restore on the batched and on the per-extent
    route, under torch.profiler (CPU + CUDA)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (Instance, RestoreEngine, SnapshotReader, StateImage,
                                  TimeLedger, build_snapshot)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        regions = build_snapshot(pool, image, working_set, "profiled",
                                 publish_fn=ops.make_fused_publish_fn())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["publish"] = _device_summary(torch, prof, wall, table=out_dir / "profile_publish.txt")
    for key, scatter in (("restore", ops.FusedScatter()),
                         ("restore_per_extent", PerExtentScatter())):
        ledger = TimeLedger()
        reader = SnapshotReader(regions, pool.host_view(f"host-{key}", ledger), pool.rdma)
        reader.invalidate_cxl()
        inst = Instance(StateImage.empty_like(image.manifest, device=image.device), ledger)
        engine = RestoreEngine(reader, inst, scatter_fn=scatter)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engine.pre_install_hot()
            engine.install_all_sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[key] = _device_summary(torch, prof, wall, table=out_dir / f"profile_{key}.txt")
        out[key]["walk_routes"] = engine.walk_routes
        check_routes(f"profiled {key}", engine.walk_routes,
                     "" if key == "restore" else "scatter_fn")
        if not torch.equal(inst.image.buf, image.buf):
            raise AssertionError(f"profiled {key} differs from the published image")
        del inst, engine, reader
    for phase, row in out.items():
        log(f"profile {phase}: wall {row['wall_ms']:.2f} ms under the profiler, device busy "
            f"{row['device_busy_ms']:.3f} ms, idle share {row['device_idle_share']:.4f}")
        for r in row["top"][:4]:
            log(f"  {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    return out


def _require_equal(name: str, got, want) -> None:
    import torch

    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version")


def check_row_kernels(torch, np, pm, fused_csum, hot_idx, cold_idx, device) -> dict:
    """The four piecemeal kernels against their plain versions on the card,
    bit for bit; returns each kernel's largest absolute difference (0)."""
    from repro_torch.kernels import page_checksum, page_gather, page_scatter, zero_detect
    from repro_torch.kernels.page_checksum.ref import page_checksum_ref
    from repro_torch.kernels.page_gather.ref import page_gather_ref
    from repro_torch.kernels.page_scatter.ref import page_scatter_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    rng = np.random.default_rng(5)
    err = dict.fromkeys(ROW_KERNELS, 0)

    def pages(rows, fill):
        if fill is not None:
            return torch.full((rows, PAGE), fill, dtype=torch.uint8, device=device)
        p = torch.from_numpy(rng.integers(0, 256, (rows, PAGE), dtype=np.uint8)).to(device)
        p[::3] = 0
        p[1::7] = 0xFF
        return p

    cases = [(name, pages(rows, fill)) for name, rows, fill in (
        ("N=0", 0, None), ("ragged N=37", 37, None), ("N=1000", 1000, None),
        ("all-zero", 64, 0), ("none-zero", 64, 7), ("all-0xFF", 64, 0xFF))]
    cases.append(("1.5 GiB image", pm))
    for name, p in cases:
        z, c = zero_detect(p), page_checksum(p)
        zr, cr = zero_detect_ref(p), page_checksum_ref(p)
        torch.cuda.synchronize()
        _require_equal(f"zero_detect ({name})", z, zr)
        _require_equal(f"page_checksum ({name})", c, cr)
        err["zero_detect"] = max(err["zero_detect"], max_abs_err([(z, zr)]))
        err["page_checksum"] = max(err["page_checksum"], max_abs_err([(c, cr)]))
        log(f"  zero_detect + page_checksum {name}: n={p.shape[0]} bit-equal")
    f = torch.zeros((5, 1024), dtype=torch.float32, device=device)
    f[1, 3] = -0.0
    f[2, :] = -0.0
    f[3, 5] = float("nan")
    f[4, 1023] = 1.0
    zf = zero_detect(f)
    _require_equal("zero_detect (float32 +-0, NaN)", zf, zero_detect_ref(f))
    if zf.tolist() != [1, 1, 1, 0, 0]:
        raise AssertionError(f"zero_detect float32 value semantics: {zf.tolist()}")
    _require_equal("page_checksum vs fused_publish's column (1.5 GiB image)",
                   page_checksum(pm), fused_csum)
    log("  zero_detect float32 +-0/NaN by value; page_checksum equals fused_publish's column")
    for name, idx in (("hot set", hot_idx), ("cold set", cold_idx),
                      ("N=0", np.zeros(0, np.int64)),
                      ("ragged N=37, permuted, repeated", rng.integers(0, pm.shape[0], 37))):
        got = page_gather(pm, idx)
        want = page_gather_ref(pm, torch.from_numpy(np.asarray(idx, np.int64)).to(device))
        torch.cuda.synchronize()
        _require_equal(f"page_gather ({name})", got, want)
        log(f"  page_gather {name}: m={len(idx)} bit-equal")
    chunk = page_gather(pm, hot_idx[:256])
    for name, m, with_src in (("256-page chunk", 256, False),
                              ("256-page chunk, src perm", 256, True),
                              ("N=0", 0, False), ("ragged N=37", 37, True)):
        dst = np.sort(rng.choice(pm.shape[0], m, replace=False))
        src = rng.permutation(256)[:m] if with_src else None
        compact = chunk if with_src else chunk[:m]
        dest_k = torch.zeros((pm.shape[0], PAGE), dtype=torch.uint8, device=device)
        dest_p = torch.zeros_like(dest_k)
        page_scatter(dest_k, compact, dst, src_indices=src)
        page_scatter_ref(dest_p, compact, torch.from_numpy(dst).to(device),
                         None if src is None else torch.from_numpy(src).to(device))
        torch.cuda.synchronize()
        _require_equal(f"page_scatter ({name})", dest_k, dest_p)
        del dest_k, dest_p
        log(f"  page_scatter {name}: m={m} bit-equal")
    check_far_rows(torch, np, chunk, device)
    return err


def check_far_rows(torch, np, chunk, device) -> None:
    """page_gather and page_scatter on rows whose byte offsets pass 2^31 in a
    3 GiB arena (64-bit offsets), against the plain versions."""
    from repro_torch.kernels import page_gather, page_scatter
    from repro_torch.kernels.page_gather.ref import page_gather_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    arena = torch.zeros((ARENA_BYTES // PAGE, PAGE), dtype=torch.uint8, device=device)
    far = np.array([arena.shape[0] - 1, 600_000, 1 << 19, (1 << 19) - 1], np.int64)
    page_scatter(arena, chunk, far, src_indices=np.array([3, 2, 1, 0]))
    far_t = torch.from_numpy(far).to(device)
    got = page_gather(arena, far)
    torch.cuda.synchronize()
    _require_equal("page_gather (rows past 2^31 bytes)", got, page_gather_ref(arena, far_t))
    _require_equal("page_scatter (rows past 2^31 bytes)", got, chunk[[3, 2, 1, 0]])
    if int(zero_detect_ref(arena).sum()) != arena.shape[0] - 4:
        raise AssertionError("page_scatter past 2^31 bytes wrote rows it was not given")
    log(f"  page_gather + page_scatter rows {far.tolist()} of a 3 GiB arena "
        f"(byte offsets up to {int(far.max()) * PAGE}): bit-equal, other rows untouched")


def gather_turns(torch, page_gather, page_gather_ref, pm, idx_t) -> dict:
    """page_gather and ``torch.index_select`` on the same rows, timed in
    turns (kernel, library, library, kernel); ``ms`` and ``library_ms`` are
    the means of each pair."""
    turns = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        fn = ((lambda: page_gather(pm, idx_t)) if name == "kernel"
              else (lambda: torch.index_select(pm, 0, idx_t)))
        turns[name].append(cuda_ms(fn, iters=20))
    return {"ms": sum(turns["kernel"]) / 2, "library_ms": sum(turns["library"]) / 2,
            "turns_ms": turns,
            "plain_ms": cuda_ms(lambda: page_gather_ref(pm, idx_t), iters=5, warmup=1)}


def time_row_kernels(torch, pm, hot_idx, cold_idx, device) -> dict:
    """CUDA-event times of zero_detect, page_checksum and page_gather, their
    plain versions and their library yardsticks at the dedup path's shapes,
    beside their bounds (page_scatter: :func:`time_row_lists`)."""
    from repro_torch.kernels import page_checksum, page_gather, zero_detect
    from repro_torch.kernels.page_checksum.ref import page_checksum_ref
    from repro_torch.kernels.page_gather.ref import page_gather_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    n = pm.shape[0]
    out = {}
    lanes = PAGE // 4
    b, by = bound_ms(n * PAGE + 4 * n, 2 * n * lanes)
    out["zero_detect"] = {
        "shape": f"full image, {n} pages", "ms": cuda_ms(lambda: zero_detect(pm), iters=20),
        "plain_ms": cuda_ms(lambda: zero_detect_ref(pm), iters=5, warmup=1),
        "library_ms": cuda_ms(lambda: pm.any(dim=1), iters=10), "library": "Tensor.any(dim=1)",
        "bound_ms": b, "bound_by": by}
    hot_t = torch.from_numpy(hot_idx).to(device)
    cold_t = torch.from_numpy(cold_idx).to(device)
    sizes = {}
    for name, idx_t in (("cold", cold_t), ("hot", hot_t)):
        m = idx_t.shape[0]
        rows = page_gather(pm, idx_t)
        bc, byc = bound_ms(m * PAGE + 4 * m, 2 * m * lanes)
        bg, byg = bound_ms(2 * m * PAGE + 8 * m, 0)
        sizes[name] = {
            "page_checksum": {
                "shape": f"{name} store batch, {m} pages",
                "ms": cuda_ms(lambda: page_checksum(rows), iters=20),
                "plain_ms": cuda_ms(lambda: page_checksum_ref(rows), iters=3, warmup=1),
                "library_ms": None, "library": None, "bound_ms": bc, "bound_by": byc},
            "page_gather": gather_turns(torch, page_gather, page_gather_ref, pm, idx_t) | {
                "shape": f"{name} set of the image, {m} pages",
                "library": "torch.index_select", "bound_ms": bg, "bound_by": byg}}
        del rows
    out["page_checksum"] = sizes["cold"]["page_checksum"]
    out["page_gather"] = sizes["cold"]["page_gather"]
    out["hot_shapes"] = {k: sizes["hot"][k] for k in ("page_checksum", "page_gather")}
    b_img, by_img = bound_ms(n * PAGE + 4 * n, 2 * n * lanes)
    out["page_checksum_full_image"] = {"ms": cuda_ms(lambda: page_checksum(pm), iters=10),
                                       "bound_ms": b_img, "bound_by": by_img}
    torch.cuda.empty_cache()
    for name in ("zero_detect", "page_checksum", "page_gather"):
        r = out[name]
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms ({r['library']})"
        log(f"  {name:13s} {r['ms']:.5f} ms at {r['shape']} (plain {r['plain_ms']:.5f} ms, "
            f"library {lib}, bound {r['bound_ms']:.6f} ms by {r['bound_by']})")
    for name, r in out["hot_shapes"].items():
        log(f"  {name:13s} {r['ms']:.5f} ms at {r['shape']} (plain {r['plain_ms']:.5f} ms, "
            f"bound {r['bound_ms']:.6f} ms)")
    for r in (out["page_gather"], out["hot_shapes"]["page_gather"]):
        log(f"  page_gather   in turns (kernel, index_select, index_select, kernel) at "
            f"{r['shape']}: {r['turns_ms']['kernel'][0]:.5f}, {r['turns_ms']['library'][0]:.5f}, "
            f"{r['turns_ms']['library'][1]:.5f}, {r['turns_ms']['kernel'][1]:.5f} ms")
    r = out["page_checksum_full_image"]
    log(f"  page_checksum {r['ms']:.5f} ms at the full image (bound {r['bound_ms']:.5f} ms)")
    return out


def walk_segments(torch, np, pm, pages: np.ndarray, chunk: int = 0):
    """A restore walk's row list as the serving layer queues it: the walk's
    pages gathered once (the extents' buffers), one segment an extent —
    ``chunk``-page chunks (the private hot walk) or the guest runs (the cold
    walk) — each a view at its own address.  Returns (segments, buffers)."""
    from repro_torch.kernels import page_gather

    buf = page_gather(pm, pages)
    if chunk:
        cuts = list(range(chunk, pages.size, chunk))
    else:
        cuts = (np.flatnonzero(np.diff(pages) != 1) + 1).tolist()
    bounds = [0, *cuts, int(pages.size)]
    segs = [(buf[a:b], None, pages[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    return segs, buf


def check_row_lists(torch, np, pm, table, walks) -> int:
    """Both row-list kernels against their plain versions at the private
    walks' shapes, bit for bit: verified installs, verify-only launches,
    forced mismatches named exactly, and the row scatter."""
    from repro_torch.kernels import ChecksumMismatchError, fused_restore_rows, page_scatter_rows
    from repro_torch.kernels.page_scatter.ref import page_scatter_rows_ref
    from repro_torch.kernels.snapshot_fuse.ref import fused_restore_rows_ref

    err = 0
    for name, (segs, _buf) in walks.items():
        dst = np.concatenate([d for _t, _r, d in segs])
        dst_t = torch.from_numpy(dst).to(pm.device)
        dest_p = torch.zeros_like(pm)
        cs_p = fused_restore_rows_ref(dest_p, segs)
        if not torch.equal(cs_p, table[dst_t]):
            raise AssertionError(f"plain checksums of the {name} walk differ from the publish")
        bad = dst[[0, dst.size // 2, dst.size - 1]]
        dest_k = torch.zeros_like(pm)
        cs = fused_restore_rows(dest_k, segs, expected_table=table)
        cs_v = fused_restore_rows(None, segs, expected_table=table, verify_only=True)
        torch.cuda.synchronize()
        _require_equal(f"fused_restore_rows ({name} walk)", dest_k, dest_p)
        _require_equal(f"fused_restore_rows csum ({name} walk)", cs, cs_p)
        _require_equal(f"fused_restore_rows verify-only ({name} walk)", cs_v, cs_p)
        err = max(err, max_abs_err([(cs, cs_p), (cs_v, cs_p)]))
        table[torch.from_numpy(bad).to(pm.device)] ^= 1
        try:
            for verify_only in (True, False):
                try:
                    fused_restore_rows(dest_k, segs, expected_table=table,
                                       verify_only=verify_only)
                except ChecksumMismatchError as e:
                    if sorted(e.bad_pages.tolist()) != sorted(bad.tolist()):
                        raise AssertionError(f"mismatch names {e.bad_pages}, want {bad}")
                else:
                    raise AssertionError("a forced checksum mismatch did not raise")
        finally:
            table[torch.from_numpy(bad).to(pm.device)] ^= 1
        dest_k.zero_()
        page_scatter_rows(dest_k, segs)
        want = page_scatter_rows_ref(torch.zeros_like(pm), segs)
        torch.cuda.synchronize()
        _require_equal(f"page_scatter_rows ({name} walk)", dest_k, want)
        del dest_k, want, dest_p
        log(f"  row lists, {name} walk ({dst.size} rows, {len(segs)} segments): "
            "fused_restore_rows installed + verify-only bit-equal, 3 forced mismatches "
            "named, page_scatter_rows bit-equal")
    torch.cuda.empty_cache()
    return err


def _turns(order, fns, iters):
    """CUDA-event ms of each named function, called in ``order``."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(cuda_ms(fns[name], iters=iters))
    return out


def time_row_lists(torch, np, pm, table, walks, cold_idx, device) -> dict:
    """At the private walks' shapes, device times of one launch of each
    row-list kernel on a device-resident row list, beside the bound, the
    plain version and the wrapper's whole flush (address build, one pinned
    upload, launch, the verify read-back).  Then the store-write form of
    page_scatter (one compact tensor of the cold set, device-resident
    indices into a 3 GiB arena), in turns with ``Tensor.index_copy_``."""
    from repro_torch import kernels
    from repro_torch.kernels import page_gather, rows
    from repro_torch.kernels.page_scatter import kernel as skernel
    from repro_torch.kernels.page_scatter.ref import page_scatter_ref, page_scatter_rows_ref
    from repro_torch.kernels.snapshot_fuse import kernel as rkernel
    from repro_torch.kernels.snapshot_fuse.ops import _weights
    from repro_torch.kernels.snapshot_fuse.ref import fused_restore_rows_ref

    weights = _weights(device)
    out = {}
    for name, (segs, _buf) in walks.items():
        dst = np.concatenate([d for _t, _r, d in segs])
        m = dst.size
        _segs, _dst, addr = rows.check_segments(name, segs, PAGE, pm.shape[0])
        idx = rows.upload([addr, dst], device)
        dest = torch.zeros_like(pm)
        csum = torch.empty(m, dtype=torch.int32, device=device)
        bad = torch.empty(m, dtype=torch.uint8, device=device)
        n_bad = torch.empty(1, dtype=torch.int32, device=device)
        fns = {
            "install": lambda: rkernel.restore_rows(dest, 0, 1, idx[0], idx[1], weights, table,
                                                    csum, bad, n_bad),
            "verify_only": lambda: rkernel.restore_rows(None, 0, 1, idx[0], idx[1], weights,
                                                        table, csum, bad, n_bad),
            "scatter": lambda: skernel.scatter_rows(dest, 0, 1, idx[0], idx[1])}
        row = {"rows": m, "segments": len(segs)}
        for op in ("install", "verify_only", "scatter"):
            b, by = bound_ms(restore_rows_bytes(m, op),
                             3 * m * (PAGE // 4) if op != "scatter" else 0)
            row[op] = {"ms": cuda_ms(fns[op], iters=20), "bound_ms": b, "bound_by": by}
            torch.cuda.synchronize()
            if op != "scatter" and (int(n_bad.item()) != 0 or not torch.equal(
                    csum, table[idx[1]])):
                raise AssertionError(f"timed {op} launches disagree with the checksum table")
        if not torch.equal(page_gather(dest, idx[1]), page_gather(pm, idx[1])):
            raise AssertionError(f"timed row-list launches left wrong rows ({name} walk)")
        row["flush_wrapper_ms"] = cuda_ms(lambda: kernels.fused_restore_rows(
            dest, segs, expected_table=table), iters=5, warmup=1)
        row["scatter_wrapper_ms"] = cuda_ms(lambda: kernels.page_scatter_rows(dest, segs),
                                            iters=5, warmup=1)
        row["plain_ms"] = cuda_ms(lambda: fused_restore_rows_ref(dest, segs), iters=1, warmup=1)
        row["scatter_plain_ms"] = cuda_ms(lambda: page_scatter_rows_ref(dest, segs), iters=1,
                                          warmup=1)
        out[name] = row
        del dest, idx
        for op in ("install", "verify_only", "scatter"):
            r = row[op]
            log(f"  row list {name} walk ({m} rows, {len(segs)} segments) {op}: "
                f"{r['ms']:.5f} ms; bound {r['bound_ms']:.5f} ms by {r['bound_by']}")
        log(f"  row list {name} walk: wrapper flush {row['flush_wrapper_ms']:.4f} ms verified, "
            f"{row['scatter_wrapper_ms']:.4f} ms scatter; plain {row['plain_ms']:.3f} / "
            f"{row['scatter_plain_ms']:.3f} ms")
    torch.cuda.empty_cache()
    # the store write: one compact tensor, device-resident destination rows
    cold_t = torch.from_numpy(cold_idx).to(device)
    compact = page_gather(pm, cold_t)
    del cold_t
    arena = torch.zeros((ARENA_BYTES // PAGE, PAGE), dtype=torch.uint8, device=device)
    at = torch.arange(compact.shape[0], device=device) * 5 % arena.shape[0]
    m = compact.shape[0]
    fns = {"kernel": lambda: skernel.scatter_rows(arena, compact.data_ptr(), PAGE, None, at),
           "library": lambda: arena.index_copy_(0, at, compact)}
    turns = _turns(("kernel", "library", "library", "kernel"), fns, iters=10)
    b, by = bound_ms(2 * m * PAGE + 8 * m, 0)
    wrapper_ms = cuda_ms(lambda: kernels.page_scatter(arena, compact, at), iters=10)
    plain_ms = cuda_ms(lambda: page_scatter_ref(arena, compact, at), iters=3, warmup=1)
    torch.cuda.synchronize()
    if not torch.equal(page_gather(arena, at), compact):
        raise AssertionError("timed store writes left the wrong rows")
    out["store_write"] = {
        "shape": f"cold store write, {m} pages from one tensor into a 3 GiB arena",
        "rows": m, "turns_ms": turns, "ms": {k: sum(t) / 2 for k, t in turns.items()},
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library": "Tensor.index_copy_",
        "bound_ms": b, "bound_by": by}
    del arena, compact, at
    torch.cuda.empty_cache()
    r = out["store_write"]
    log(f"  page_scatter  store write ({m} rows), in turns kernel, library, library, kernel: "
        + ", ".join(f"{k} {r['ms'][k]:.5f} ms {turns[k]}" for k in turns)
        + f"; wrapper {wrapper_ms:.5f} ms; plain {plain_ms:.5f} ms; bound {b:.5f} ms")
    return out


class PerExtentScatter:
    """A scatter without a batched form, so every bulk walk runs per extent
    (the route before batched walks, kept to time against them): it wraps a
    ``FusedScatter`` (verified once bound) or ``page_scatter``."""

    def __init__(self, inner=None):
        from repro_torch.kernels import FusedScatter

        self.inner = FusedScatter() if inner is None else inner
        self.stats = getattr(self.inner, "stats", None)

    def bind_checksums(self, table) -> "PerExtentScatter":
        return PerExtentScatter(self.inner.bind_checksums(table))

    def __call__(self, *args, **kwargs):
        return self.inner(*args, **kwargs)


def check_routes(where: str, routes: dict, per_extent: str = "", walks: int = 2) -> None:
    """Every one of the ``walks`` walks with rows took the batched route
    (``per_extent`` given: every walk stayed per extent for that reason)."""
    total = routes["batched"] + sum(routes["per_extent"].values())
    want = ({"batched": total, "per_extent": dict.fromkeys(routes["per_extent"], 0)}
            if not per_extent else
            {"batched": 0, "per_extent": {k: (total if k == per_extent else 0)
                                          for k in routes["per_extent"]}})
    if routes != want or total != walks:
        raise AssertionError(f"{where}: walk routes {routes}, want {want} over {walks} walks")


def restore_once(torch, pool, regions, src_buf, manifest, scatter) -> dict:
    """One restore (pre-install, then install everything) of a published
    snapshot through ``RestoreEngine`` on a fresh host view and instance,
    compared with its source; wall time and the walks' routes."""
    from repro_torch import core

    ledger = core.TimeLedger()
    reader = core.SnapshotReader(regions, pool.host_view(f"turn-{time.perf_counter_ns()}",
                                                         ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = core.Instance(core.StateImage.empty_like(manifest, device=src_buf.device), ledger)
    eng = core.RestoreEngine(reader, inst, scatter_fn=scatter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.pre_install_hot()
    eng.install_all_sync()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not torch.equal(inst.image.buf, src_buf):
        raise AssertionError(f"restore of {regions.name} differs from its source")
    stats = getattr(inst.scatter_fn, "stats", None)
    verified = None if stats is None else stats["pages_verified"]
    if (verified is not None and reader.page_checksums() is not None
            and verified != regions.n_hot + regions.n_cold):
        raise AssertionError(f"{regions.name}: {verified} pages verified")
    return {"restore_s": wall, "walk_routes": eng.walk_routes, "pages_verified": verified,
            "modeled_ledger_s": dict(ledger.seconds), "modeled_total_s": ledger.total()}


def route_turns(torch, where: str, restore, batched_scatter, per_extent_scatter) -> dict:
    """Restore walls of one snapshot on the batched and the per-extent route,
    in turns (batched, per-extent, per-extent, batched), routes asserted."""
    out = {"batched": [], "per_extent": []}
    for route in ("batched", "per_extent", "per_extent", "batched"):
        r = restore(batched_scatter() if route == "batched" else per_extent_scatter())
        check_routes(f"{where} ({route})", r["walk_routes"],
                     "" if route == "batched" else "scatter_fn")
        out[route].append(r["restore_s"])
    log(f"  {where} restore in turns (batched, per-extent, per-extent, batched): batched "
        f"{', '.join(f'{t * 1e3:.2f}' for t in out['batched'])} ms, per-extent "
        f"{', '.join(f'{t * 1e3:.2f}' for t in out['per_extent'])} ms wall; bit-identical")
    return out


def make_variant(torch, base: "torch.Tensor", hot_t, cold_t, d: int, v: int, seed: int):
    """Variant ``v`` of the fleet: the base image with its hot pages at ranks
    [v*d, (v+1)*d) and all its cold pages drawn anew from ``(seed, v)``."""
    g = torch.Generator(device=base.device)
    g.manual_seed(seed * 1_000_003 + 7919 * (v + 1))
    buf = base.clone()
    rows = torch.cat([hot_t[v * d : (v + 1) * d], cold_t])
    buf.view(-1, PAGE)[rows] = torch.randint(0, 256, (rows.numel(), PAGE), dtype=torch.uint8,
                                             generator=g, device=base.device)
    return buf


def i6_holds(np, core, pool, all_regions) -> bool:
    """Store refcounts == live offset-array slots pointing at them, per tier."""
    for store, tag in ((pool.dedup_cxl, core.TIER_CXL), (pool.dedup_rdma, core.TIER_RDMA)):
        want = {}
        for r in all_regions:
            uniq, counts = np.unique(core.decode_dedup_offsets(pool, r, tag), return_counts=True)
            for off, k in zip(uniq.tolist(), counts.tolist()):
                want[off] = want.get(off, 0) + k
        if want != store.refcounts():
            return False
    return True


def dedup_phase(torch, np, base_buf, working_set, cold_idx, manifest, seed, out_dir) -> dict:
    """Publish, restore, check and free the four-variant fleet (see the
    module docstring); returns the phase's numbers."""
    from repro_torch import core
    from repro_torch.kernels import (FusedScatter, fused_publish, fused_restore,
                                     make_fused_publish_fn, page_checksum, page_gather,
                                     page_scatter, zero_detect)

    device = base_buf.device
    n_hot, n_cold = int(working_set.size), int(cold_idx.size)
    d = round(n_hot * 12 / 256)
    hot_t = torch.from_numpy(working_set).to(device)
    cold_t = torch.from_numpy(cold_idx).to(device)
    t0 = time.perf_counter()
    variants = [make_variant(torch, base_buf, hot_t, cold_t, d, v, seed)
                for v in range(N_VARIANTS)]
    torch.cuda.synchronize()
    rep = {"n_variants": N_VARIANTS, "n_hot": n_hot, "n_cold": n_cold, "delta_pages": d,
           "make_s": time.perf_counter() - t0, "publishes": [], "restores": []}
    counted = {"zero_detect": zero_detect, "page_checksum": page_checksum,
               "page_gather": page_gather, "page_scatter": page_scatter,
               "fused_publish": fused_publish, "fused_restore": fused_restore}
    for k in counted.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = core.HierarchicalPool(device=device, rdma_capacity=ARENA_BYTES,
                                 dedup_hash_fn=core.poly32_hash_fn)
    stores = (pool.dedup_cxl, pool.dedup_rdma)
    regions = []
    for v, buf in enumerate(variants):
        image = core.StateImage(manifest, buf)
        kw = {} if v < 2 else {"publish_fn": make_fused_publish_fn()}
        est = (core.estimate_snapshot_cxl_size(image, working_set, dedup=True, pool=pool)
               if v == 3 else None)
        before = [(s.stats["unique"], s.stats["dedup_hits"], s.decide_s) for s in stores]
        cxl_before = pool.cxl.bytes_in_use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regions.append(core.build_snapshot(pool, image, working_set, f"v{v}", version=v,
                                           dedup=True, **kw))
        torch.cuda.synchronize()
        row = {"variant": v, "route": "kernels" if v < 2 else "fused",
               "publish_s": time.perf_counter() - t0,
               "cxl_bytes_added": pool.cxl.bytes_in_use - cxl_before, "cxl_estimate": est}
        for (u0, h0, s0), s, tier in zip(before, stores, ("cxl", "rdma")):
            row[f"{tier}_new"] = s.stats["unique"] - u0
            row[f"{tier}_hits"] = s.stats["dedup_hits"] - h0
            row[f"{tier}_decide_s"] = s.decide_s - s0
        rep["publishes"].append(row)
        if est is not None and est != row["cxl_bytes_added"]:
            raise AssertionError(f"estimate {est} != CXL bytes the publish added "
                                 f"{row['cxl_bytes_added']}")
        if v >= 2 and row["cxl_hits"] != n_hot - d:
            raise AssertionError(f"variant {v}: {row['cxl_hits']} hot hits on stored base "
                                 f"pages, want {n_hot - d}")
        log(f"  publish v{v} ({row['route']}): {row['publish_s'] * 1e3:.2f} ms wall; new "
            f"cxl {row['cxl_new']} rdma {row['rdma_new']}, hits cxl {row['cxl_hits']} "
            f"rdma {row['rdma_hits']}; host decision {row['cxl_decide_s'] * 1e3:.2f} + "
            f"{row['rdma_decide_s'] * 1e3:.2f} ms")
    want_scatter = 2 * N_VARIANTS      # one store write per put_pages with new rows
    want_restore = 0
    for v, (reg, buf) in enumerate(zip(regions, variants)):
        scatter = None if v < 2 else FusedScatter()
        row = restore_once(torch, pool, reg, buf, manifest, scatter)
        row["variant"] = v
        rep["restores"].append(row)
        check_routes(f"dedup v{v}", row["walk_routes"])
        walks = row["walk_routes"]["batched"]
        if v < 2:
            want_scatter += walks          # one install a walk
        else:
            want_restore += 2 * walks      # a verify-only launch and an install a walk
        log(f"  restore v{v} ({'page_scatter' if v < 2 else 'fused, verified'}): "
            f"{row['restore_s'] * 1e3:.2f} ms wall, {walks} batched walks, bit-identical; "
            f"modeled {row['modeled_total_s'] * 1e3:.4f} ms")
    t0 = time.perf_counter()
    back = core.reconstruct_image(pool, regions[3])
    torch.cuda.synchronize()
    rep["reconstruct_s"] = time.perf_counter() - t0
    if not torch.equal(back.buf, variants[3]):
        raise AssertionError("reconstruct_image of v3 differs from its source")
    del back
    want_scatter += 2
    launches = {name: k.launches for name, k in counted.items()}
    rep["launches"] = launches
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    want = {"zero_detect": 3, "page_checksum": 5, "page_gather": 7, "page_scatter": want_scatter,
            "fused_publish": 2, "fused_restore": want_restore}
    rep["expected_launches"] = want
    if launches != want:
        raise AssertionError(f"dedup launch counts {launches}, want {want}")
    cxl, rdma = pool.dedup_cxl, pool.dedup_rdma
    rep["stores"] = {"cxl": cxl.report(), "rdma": rdma.report()}
    checks = {"cxl unique": (cxl.stats["unique"], n_hot + N_VARIANTS * d),
              "rdma unique": (rdma.stats["unique"], N_VARIANTS * n_cold),
              "cxl hits": (cxl.stats["dedup_hits"], N_VARIANTS * n_hot - cxl.stats["unique"]),
              "rdma hits": (rdma.stats["dedup_hits"], N_VARIANTS * n_cold - rdma.stats["unique"]),
              "cxl logical": (cxl.logical_pages(), N_VARIANTS * n_hot),
              "rdma logical": (rdma.logical_pages(), N_VARIANTS * n_cold)}
    for name, (got, exp) in checks.items():
        if got != exp:
            raise AssertionError(f"dedup {name}: {got}, want {exp}")
    if not i6_holds(np, core, pool, regions):
        raise AssertionError("I6: store refcounts differ from the live offset arrays")
    rep["collisions"] = {"cxl": cxl.stats["collisions"], "rdma": rdma.stats["collisions"]}
    log(f"  stores: cxl unique {cxl.stats['unique']} (= n_hot + 4d) hits "
        f"{cxl.stats['dedup_hits']}; rdma unique {rdma.stats['unique']} (= 4 n_cold) hits "
        f"{rdma.stats['dedup_hits']}; collisions cxl {cxl.stats['collisions']} rdma "
        f"{rdma.stats['collisions']}; I6 holds; reconstruct v3 "
        f"{rep['reconstruct_s'] * 1e3:.2f} ms, bit-identical")
    log(f"  launches {launches} as the fleet's shape implies; peak device memory "
        f"{rep['peak_mem_bytes'] / 2**30:.3f} GiB")

    def per_extent_page_scatter(*args, **kwargs):      # page_scatter, no batched form
        return page_scatter(*args, **kwargs)

    rep["routes_in_turns"] = {
        f"v{v}": route_turns(
            torch, f"dedup v{v} ({label})",
            lambda scatter, v=v: restore_once(torch, pool, regions[v], variants[v], manifest,
                                              scatter),
            batched, per_extent)
        for v, label, batched, per_extent in (
            (0, "page_scatter", lambda: None, lambda: per_extent_page_scatter),
            (2, "fused, verified", FusedScatter, PerExtentScatter))}
    rep["profile"] = profile_dedup(torch, core, pool, base_buf, hot_t, cold_t, d, seed,
                                   working_set, manifest, out_dir)
    t0 = time.perf_counter()
    for reg in regions:
        core.free_snapshot(pool, reg)
    rep["free_s"] = time.perf_counter() - t0
    if (cxl.unique_pages() or rdma.unique_pages() or pool.cxl.bytes_in_use
            or pool.rdma.bytes_in_use):
        raise AssertionError("freeing the fleet left pages in the stores")
    log(f"  freed the fleet in {rep['free_s'] * 1e3:.2f} ms: both stores empty, "
        "both tiers' bytes_in_use 0")
    return rep


def profile_dedup(torch, core, pool, base_buf, hot_t, cold_t, d, seed, working_set, manifest,
                  out_dir) -> dict:
    """One more variant published (kernel route) and restored on the batched
    and on the per-extent route under torch.profiler while the fleet is
    stored; freed afterwards."""
    from torch.profiler import ProfilerActivity, profile

    buf = make_variant(torch, base_buf, hot_t, cold_t, d, N_VARIANTS, seed)
    image = core.StateImage(manifest, buf)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        reg = core.build_snapshot(pool, image, working_set, "profiled", dedup=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["publish"] = _device_summary(torch, prof, wall, table=out_dir / "profile_dedup_publish.txt")
    from repro_torch.kernels import page_scatter

    def per_extent_page_scatter(*args, **kwargs):      # page_scatter, no batched form
        return page_scatter(*args, **kwargs)

    for key, scatter in (("restore", None), ("restore_per_extent", per_extent_page_scatter)):
        ledger = core.TimeLedger()
        reader = core.SnapshotReader(reg, pool.host_view(f"host-profiled-{key}", ledger),
                                     pool.rdma)
        reader.invalidate_cxl()
        inst = core.Instance(core.StateImage.empty_like(manifest, device=buf.device), ledger)
        eng = core.RestoreEngine(reader, inst, scatter_fn=scatter)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.pre_install_hot()
            eng.install_all_sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[key] = _device_summary(torch, prof, wall,
                                   table=out_dir / f"profile_dedup_{key}.txt")
        out[key]["walk_routes"] = eng.walk_routes
        check_routes(f"profiled dedup {key}", eng.walk_routes,
                     "" if key == "restore" else "scatter_fn")
        if not torch.equal(inst.image.buf, buf):
            raise AssertionError(f"profiled dedup {key} differs from its source")
        del inst, eng, reader
    core.free_snapshot(pool, reg)
    for phase, row in out.items():
        log(f"  profile dedup {phase}: wall {row['wall_ms']:.2f} ms under the profiler, "
            f"device busy {row['device_busy_ms']:.3f} ms, idle share "
            f"{row['device_idle_share']:.4f}")
        for r in row["top"][:4]:
            log(f"    {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    return out


def _guest(engine, trace, lat: list) -> None:
    """The guest thread: touch ``trace`` through ``engine.access``; the
    service time of every page absent at its touch goes to ``lat``."""
    present = engine.instance.present
    for p in trace.tolist():
        if present[p]:
            engine.access(p)
            continue
        t0 = time.perf_counter()
        engine.access(p, timeout_s=120.0)
        lat.append(time.perf_counter() - t0)


def _pod_restores(np, ops, orch_a, orch_b, name: str, seed: int, on_borrowed=None):
    """Restore ``name`` ``POD_SESSIONS`` times on host a through its node
    server: every session attaches first (one fan-out group), then each
    session's own thread pre-installs the hot set, installs the zero runs,
    starts the prefetcher, runs its guest trace and waits for the last cold
    page.  With ``orch_b``, one more restore through host b's plain entry
    point runs beside them in a thread of its own, and ``on_borrowed`` runs
    once all the borrows are out.  Every restore gets its own FusedScatter,
    so its verified pages are its own.  Returns ``(restored, records)``."""
    import threading

    ris, recs, errs = [], [], []
    for _ in range(POD_SESSIONS):
        orch_a.scatter_fn = ops.FusedScatter()
        t0 = time.perf_counter()
        ri = orch_a.restore(name, pre_install=False, prefetch_cold=False)
        if ri is None:
            raise AssertionError(f"host a: the borrow of {name} failed")
        ris.append(ri)
        recs.append({"host": "a", "attach_s": time.perf_counter() - t0, "fault_s": [],
                     "scatter": ri.instance.scatter_fn.stats})

    def trace(ri, k):
        cold = ri.engine.reader.cold_page_indices()
        return np.random.default_rng(seed + k).permutation(cold)[:POD_TOUCHES]

    def finish(ri, rec, k, t0):
        ri.engine.install_zero_runs()
        if rec["host"] == "a":                # host b's restore() started its prefetcher
            ri.engine.start_prefetcher()
        _guest(ri.engine, trace(ri, k), rec["fault_s"])
        if not ri.engine.wait_prefetch_idle(300.0):
            raise AssertionError(f"{rec['host']}: cold pages still absent after 300 s")
        if not ri.instance.all_present():
            raise AssertionError(f"{rec['host']}: pages absent after the restore")
        rec["to_full_s"] = rec.get("attach_s", 0.0) + time.perf_counter() - t0

    def run_a(k):
        ri, rec = ris[k], recs[k]
        try:
            t0 = time.perf_counter()
            ri.engine.pre_install_hot()
            rec["to_hot_s"] = rec["attach_s"] + time.perf_counter() - t0
            finish(ri, rec, k, t0)
        except BaseException as e:           # re-raised by the main thread
            errs.append(e)

    b_in = threading.Event()

    def run_b():
        try:
            orch_b.scatter_fn = ops.FusedScatter()
            t0 = time.perf_counter()
            ri = orch_b.restore(name)         # borrow, flush, pre-install, prefetch
            if ri is None:
                raise AssertionError(f"host b: the borrow of {name} failed")
            rec = {"host": "b", "to_hot_s": time.perf_counter() - t0, "fault_s": [],
                   "scatter": ri.instance.scatter_fn.stats}
            ris.append(ri)
            recs.append(rec)
            b_in.set()
            finish(ri, rec, POD_SESSIONS, t0)
        except BaseException as e:
            errs.append(e)
        finally:
            b_in.set()

    # daemon threads: a failed run exits at once, never waiting on a restore
    threads = [threading.Thread(target=run_a, args=(k,), daemon=True)
               for k in range(POD_SESSIONS)]
    if orch_b is not None:
        threads.append(threading.Thread(target=run_b, daemon=True))
    for t in threads:
        t.start()
    if orch_b is not None:
        b_in.wait(timeout=300.0)
        if on_borrowed is not None and not errs:
            on_borrowed()
    for t in threads:
        t.join(timeout=600.0)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a restore thread did not finish within 600 s")
    return ris, recs


def _pct(np, xs, q):
    return float(np.percentile(xs, q)) * 1e3 if len(xs) else None


def pod_phase(torch, np, image, working_set, cold_idx, seed: int, out_dir: Path) -> dict:
    """The pod's control plane at the paper's instance size (see the module
    docstring): PoolMaster.publish, 8 + 1 co-located demand-paged restores
    through Orchestrator with a profiled window once their borrows are out,
    an update that drains under them, the update restored as version 1,
    delete and gc."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (STATE_TOMBSTONE, HierarchicalPool, NodePageServer,
                                  Orchestrator, PoolMaster, RestoreEngine, StateImage)
    from repro_torch.kernels.snapshot_fuse import ops

    device = image.buf.device
    name = "inst"
    g = torch.Generator(device=device)
    g.manual_seed(seed + 17)
    nonzero = torch.from_numpy(np.concatenate([working_set, cold_idx])).to(device)
    delta = nonzero[torch.randperm(nonzero.numel(), generator=g, device=device)[:POD_DELTA]]
    image2 = StateImage(image.manifest, image.buf.clone())
    image2.pages_matrix()[delta] = torch.randint(1, 256, (delta.numel(), PAGE),
                                                 dtype=torch.uint8, generator=g, device=device)
    counted = data_plane_wrappers()
    threads_before = set(threading.enumerate())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counted.values():
        k.launches = 0
    t_phase = time.perf_counter()

    pool = HierarchicalPool(device=device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    master = PoolMaster(pool, publish_fn=ops.make_fused_publish_fn())
    t0 = time.perf_counter()
    v0 = master.publish(name, image, working_set)
    torch.cuda.synchronize()
    rep = {"publish_s": time.perf_counter() - t0, "n_hot": v0.n_hot, "n_cold": v0.n_cold,
           "n_zero": v0.n_zero, "sessions": POD_SESSIONS, "touches": POD_TOUCHES,
           "delta_pages": POD_DELTA}
    server_a = NodePageServer("a", pool)
    orch_a = Orchestrator("a", pool, master.catalog, node_server=server_a)
    orch_b = Orchestrator("b", pool, master.catalog, prefetch_cold=True)
    entry = master.catalog.find(name)
    in_use0 = (pool.cxl.bytes_in_use, pool.rdma.bytes_in_use)
    upd = {}

    def update():
        """The owner's update through ``publish_steps``, polling the entry's
        refcount once a millisecond while it drains.  A pod's master runs on
        a host of its own; in this one process, ``publish``'s 10 µs poll
        would take the interpreter lock from the restores thousands of times
        a second."""
        try:
            for label, value in master.publish_steps(name, image2, working_set):
                upd["label"] = label
                if label == "draining":
                    upd["polls"] = upd.get("polls", 0) + 1
                    time.sleep(1e-3)
                elif label == "done":
                    upd["regions"] = value
        except BaseException as e:           # re-raised by the main thread
            upd["error"] = e

    updater = threading.Thread(target=update, daemon=True)

    def on_borrowed():
        """All nine borrows are out: start the update, and profile a window
        of the restores (the profiler traces every thread's launches)."""
        updater.start()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(POD_PROFILE_S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rep["profile_window"] = _device_summary(torch, prof, wall,
                                                table=out_dir / "profile_pod_window.txt")

    # 1. the measured run: 8 sessions on host a, one on host b, the update
    # started once all nine borrows are out
    t0 = time.perf_counter()
    ris, recs = _pod_restores(np, ops, orch_a, orch_b, name, seed, on_borrowed=on_borrowed)
    torch.cuda.synchronize()
    rep["restores_wall_s"] = time.perf_counter() - t0
    chunks_a, server_stats_a = dict(server_a.chunks.stats), dict(server_a.stats)
    srv_b = orch_b._owned_server
    for ri in ris:
        if not torch.equal(ri.instance.image.buf, image.buf):
            raise AssertionError(f"pod: a restore on host {ri.engine.reader.view.host} "
                                 "differs from the published image")
        verified = ri.instance.scatter_fn.stats["pages_verified"]
        if verified != v0.n_hot + v0.n_cold:
            raise AssertionError(f"pod: {verified} pages verified, want {v0.n_hot + v0.n_cold}")
        check_routes("pod restore", ri.engine.walk_routes, walks=1)
    n_chunks = -(-v0.n_hot // RestoreEngine.HOT_CHUNK_PAGES)
    if (chunks_a["reads"], chunks_a["fanout_hits"]) != (n_chunks, (POD_SESSIONS - 1) * n_chunks):
        raise AssertionError(f"pod: group a chunk stats {chunks_a}, want {n_chunks} reads and "
                             f"{(POD_SESSIONS - 1) * n_chunks} fan-out hits")
    if server_stats_a["fanout_installs"] <= 0:
        raise AssertionError(f"pod: no fan-out install on host a: {server_stats_a}")

    # 2. the update drains until the last borrow goes
    def draining() -> bool:
        return (updater.is_alive() and upd.get("label") == "draining"
                and entry.state.load() == STATE_TOMBSTONE and entry.regions is v0
                and (pool.cxl.bytes_in_use, pool.rdma.bytes_in_use) == in_use0)

    ledger_a, ledger_b = dict(ris[0].ledger.seconds), dict(ris[-1].ledger.seconds)
    drained_checks = 0
    for ri in ris:
        if not draining():
            raise AssertionError(f"pod: the update is not draining with {ri.borrow.entry.refcount.load()}"
                                 f" borrows out ({upd})")
        drained_checks += 1
        ri.shutdown()
    updater.join(timeout=120.0)
    if updater.is_alive() or "regions" not in upd:
        raise AssertionError(f"pod: the update did not finish after the last release: {upd}")
    v1 = upd["regions"]
    if v1.version != 1:
        raise AssertionError(f"pod: the update published version {v1.version}, want 1")
    del ris
    # host b restores the new version: borrow, clflushopt, walks
    orch_b.scatter_fn = ops.FusedScatter()
    ri = orch_b.restore(name, prefetch_cold=False)
    ri.engine.install_all_sync()
    torch.cuda.synchronize()
    if ri.borrow.version != 1 or not torch.equal(ri.instance.image.buf, image2.buf):
        raise AssertionError("pod: the restore of version 1 differs from the updated image")
    if ri.instance.scatter_fn.stats["pages_verified"] != v1.n_hot + v1.n_cold:
        raise AssertionError("pod: not every page of version 1 was verified")
    check_routes("pod version-1 restore", ri.engine.walk_routes)
    b2 = {"scatter": ri.instance.scatter_fn.stats, "walks": ri.engine.walk_routes["batched"],
          "cold_extents": sum(1 for _ in ri.engine.reader.iter_cold_extents(
              max_extent_pages=1 << 30, largest_first=False))}
    ri.shutdown()
    del ri
    launches = {n: k.launches for n, k in counted.items()}
    if launches["fused_publish"] != 2:
        raise AssertionError(f"pod: fused_publish launched {launches['fused_publish']} times, "
                             "want 2 (the publish and the update)")
    # every fused_restore launch accounted: a direct install a batch not
    # queued, and a verify-only launch and an install a batched walk
    queued = len(recs) * n_chunks + (-(-v1.n_hot // RestoreEngine.HOT_CHUNK_PAGES)
                                     + b2["cold_extents"])
    batches = sum(r["scatter"]["batches"] for r in recs) + b2["scatter"]["batches"]
    walks = len(recs) + b2["walks"]
    want_restore = batches - queued + 2 * walks
    if launches["fused_restore"] != want_restore:
        raise AssertionError(f"pod: fused_restore launched {launches['fused_restore']} times, "
                             f"want {want_restore}")
    others = {n: c for n, c in launches.items() if n in ROW_KERNELS and c}
    if others:
        raise AssertionError(f"pod: launches of kernels off the pod's path: {others}")
    rep["launches"] = launches
    rep["launch_parts"] = {"direct_installs": batches - queued, "batched_walks": walks}
    rep["wall_to_update_s"] = time.perf_counter() - t_phase

    # 3. delete and gc: every byte back, servers parked, no thread left
    if not master.delete(name) or master.gc() != 0:
        raise AssertionError("pod: delete did not reclaim the snapshot at once")
    if (pool.cxl.free_list(), pool.rdma.free_list()) != free0 or pool.cxl.bytes_in_use \
            or pool.rdma.bytes_in_use:
        raise AssertionError(f"pod: pool not back to its start: cxl {pool.cxl.free_list()} "
                             f"rdma {pool.rdma.free_list()}")
    for srv in (server_a, srv_b):
        if srv._pump_thread is not None or srv._completion_thread is not None \
                or srv.engine._worker.is_alive() or srv.buffers.outstanding:
            raise AssertionError(f"pod: node server {srv.host} not parked "
                                 f"(outstanding buffers {srv.buffers.outstanding})")
    orch_a.close()
    orch_b.close()
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"pod: threads left after the phase: {left}")
    torch.cuda.synchronize()
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()

    faults = [x for r in recs for x in r["fault_s"]]
    rep["instances"] = [{k: v for k, v in r.items() if k not in ("fault_s", "scatter")}
                        | {"faults": len(r["fault_s"])} for r in recs]
    rep["fault_ms"] = {"n": len(faults), "p50": _pct(np, faults, 50), "p99": _pct(np, faults, 99),
                       "max": max(faults) * 1e3 if faults else None}
    rep["chunks_a"], rep["server_a"] = chunks_a, server_stats_a
    rep["server_b"] = dict(srv_b.stats)
    rep["longest_install_ms"] = {"a": server_a.longest_install_s * 1e3,
                                 "b": srv_b.longest_install_s * 1e3}
    rep["install_share"] = {"a": server_a.install_s / rep["restores_wall_s"],
                            "b": srv_b.install_s / rep["restores_wall_s"]}
    rep["engines"] = {"a": dict(server_a.engine.stats), "b": dict(srv_b.engine.stats)}
    rep["drain_checks"], rep["drain_polls"] = drained_checks, upd["polls"]
    rep["modeled_ledger_s"] = {"a0": ledger_a, "b": ledger_b}
    rep["modeled_total_s"] = {"a0": sum(ledger_a.values()), "b": sum(ledger_b.values())}
    return rep


def log_pod(rep: dict, card: str) -> None:
    ms = {k: v * 1e3 for k, v in rep.items() if k.endswith("_s") and isinstance(v, float)}
    log(f"  [{card}] publish {ms['publish_s']:.2f} ms; n_hot={rep['n_hot']} "
        f"n_cold={rep['n_cold']} n_zero={rep['n_zero']}; {rep['sessions']} + 1 restores "
        f"{ms['restores_wall_s']:.1f} ms wall; phase {ms['phase_wall_s']:.1f} ms wall")
    for i, r in enumerate(rep["instances"]):
        log(f"  [{card}] instance {i} host {r['host']}: time to hot "
            f"{r['to_hot_s'] * 1e3:.2f} ms, to full {r['to_full_s'] * 1e3:.2f} ms, "
            f"{r['faults']} pages absent at the touch")
    f = rep["fault_ms"]
    log(f"  [{card}] fault service of access() on absent pages: n={f['n']} "
        f"p50 {f['p50']} ms p99 {f['p99']} ms max {f['max']} ms; longest install by a "
        f"completion worker {rep['longest_install_ms']} ms; its installs' share of the "
        f"restores' wall {rep['install_share']}")
    p = rep["profile_window"]
    log(f"  [{card}] profiled {p['wall_ms']:.1f} ms window of the 8 + 1 restores: device "
        f"busy {p['device_busy_ms']:.3f} ms, idle share {p['device_idle_share']:.4f}")
    for r in p["top"][:4]:
        log(f"    {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    log(f"  [{card}] peak device memory {rep['peak_mem_bytes'] / 2**30:.3f} GiB")
    log(f"  [{card}] group a chunks {rep['chunks_a']}; fan-out installs "
        f"{rep['server_a']['fanout_installs']}, demand reads {rep['server_a']['demand_reads']}; "
        f"update drained ({rep['drain_polls']} polls) under {rep['drain_checks']} borrows, "
        f"then version 1 restored "
        f"bit-identically; launches {rep['launches']} ({rep['launch_parts']})")
    log(f"  [{card}] modeled (paper cost model, not device time): instance a0 "
        f"{rep['modeled_total_s']['a0'] * 1e3:.4f} ms, b {rep['modeled_total_s']['b'] * 1e3:.4f} "
        f"ms {json.dumps(rep['modeled_ledger_s']['a0'])}")


def topology_phase(torch, np, image, working_set, cold_idx, seed: int) -> dict:
    """Cell (6), the multi-pod topology at the 1.5 GiB instance (see the
    module docstring): ``sim_scenarios.topology_cell`` on three pods of two
    MHD ports, every pod master publishing through the fused sweep and the
    restore installing through ``FusedScatter``, I1–I8 after every step;
    then the launch counts the path must make."""
    import gc

    import sim_scenarios as sims

    from repro_torch.core import HostView, runs_of_indices
    from repro_torch.kernels.snapshot_fuse import ops

    device = image.buf.device
    rng = np.random.default_rng(seed + 19)
    nonzero = np.concatenate([working_set, cold_idx])
    delta = np.sort(rng.choice(nonzero, POD_DELTA, replace=False))
    v1 = sims.rewrite_pages(image, delta, seed + 19)
    n = image.total_pages
    mib = 1 << 20
    # each tier sized for two versions of the snapshot; the owner protocol frees the
    # old version before it rebuilds, so one version at a time is resident
    cxl = -(-2 * (working_set.size * PAGE + n * 8 + mib) // mib) * mib
    rdma = -(-2 * (cold_idx.size * PAGE + mib) // mib) * mib
    n_cold_runs = int(runs_of_indices(cold_idx).shape[0])
    want = {"fused_publish": 5, "fused_restore": 2 + n_cold_runs}
    counted = data_plane_wrappers()
    gc.collect()
    views0 = sum(isinstance(o, HostView) for o in gc.get_objects())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in counted.values():
        k.launches = 0
    t0 = time.perf_counter()
    c, rep = sims.topology_cell(seed, device, (image, working_set), (v1, working_set),
                                TOPO_READ_PAGES, cxl, rdma,
                                publish_fn=ops.make_fused_publish_fn(),
                                scatter_fn=ops.FusedScatter(), name="inst")
    torch.cuda.synchronize()
    rep["phase_wall_s"] = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counted.items()}
    rep.update(launches=launches, expected_launches=want, n_cold_runs=n_cold_runs,
               delta_pages=POD_DELTA, arena_bytes={"cxl": cxl, "rdma": rdma},
               read_pages=TOPO_READ_PAGES,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               peak_mem_above_start_bytes=torch.cuda.max_memory_allocated() - base_mem)
    del c, v1
    gc.collect()
    rep["host_views_left"] = sum(isinstance(o, HostView) for o in gc.get_objects()) - views0
    if rep["host_views_left"]:
        raise AssertionError(f"topology: {rep['host_views_left']} HostViews (each with a "
                             f"shadow as large as its CXL tier) outlived the cluster")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"topology: launch counts {launches}, want {want} (one publish "
                             f"a pod a group write; a verify-only launch and a flush for the "
                             f"batched hot walk, one install a cold run)")
    return rep


def log_topology(rep: dict, card: str) -> None:
    w = {k: v * 1e3 for k, v in rep["walls_s"].items()}
    log(f"  [{card}] 3 pods x 2 ports, arenas cxl {rep['arena_bytes']['cxl'] / 2**20:.0f} MiB "
        f"rdma {rep['arena_bytes']['rdma'] / 2**20:.0f} MiB a pod; {rep['steps']} steps, "
        f"I1-I8 checked {rep['checks_run']} times; phase {rep['phase_wall_s']:.2f} s wall")
    log(f"  [{card}] walls inside each program's own steps: group publish v0 "
        f"{w['publish_v0']:.2f} ms, update v1 {w['update_v1']:.2f} ms "
        f"({rep['update_drain_polls']} drain polls), restore {w['restore']:.2f} ms, "
        f"migration (reconstruct + publish + retire) {w['migrate']:.2f} ms, the 9 borrowers "
        f"{rep['borrowers_s'] * 1e3:.2f} ms, the I1-I8 checks {w['checks']:.2f} ms")
    log(f"  [{card}] routing {rep['replica_stats']}; router {rep['router_stats']}; "
        f"fallthrough by pod {rep['fallthrough_by_pod']}; migration {rep['migration']}; "
        f"pod-0 borrower routed {rep['partition']}; "
        f"pod 1 held a replica when lost: {rep['promoted_pod1_replica']}")
    log(f"  [{card}] borrowers {rep['borrowers']}; restored {rep['restored']}; modeled "
        f"inter-pod (paper cost model, not device time) {rep['modeled_interpod_s'] * 1e3:.4f} ms")
    log(f"  [{card}] every borrowed page, the restore and the migrated replica bit-identical; "
        f"free lists back to the start; launches {rep['launches']} (want "
        f"{rep['expected_launches']}); peak device memory "
        f"{rep['peak_mem_bytes'] / 2**30:.3f} GiB; no HostView left")


def sim_phase(torch) -> dict:
    """The simulator's scenario matrix on the card: every scenario of
    ``scripts/sim_scenarios.py`` at the tests' seed, the drift and dedup sets
    at seed offsets 0–2, and the dedup scenarios with ``page_checksum`` as
    the stores' hash, each on the CPU and on the card in this process; the
    two runs must agree (``sim_scenarios.cuda_parity``).  Every data-plane
    wrapper must have launched."""
    import sim_scenarios as sims

    from repro_torch.core.dedup import poly32_hash_fn

    runs = [(name, sims.SCENARIOS[name], sims.scenario_seed(name), {})
            for name in sorted(sims.SCENARIOS)]
    runs += [(name, sims.TOPOLOGY_SCENARIOS[name], sims.topology_seed(name), {})
             for name in sorted(sims.TOPOLOGY_SCENARIOS)]
    runs += [(f"{name}@{o}", sims.SCENARIOS[name], seed_of(o), {})
             for pairs in sims.MULTI_SEED.values() for o in (0, 1, 2)
             for name, seed_of in pairs]
    runs += [(f"{name}+page_checksum", sims.SCENARIOS[name], sims.scenario_seed(name),
              {"dedup_hash_fn": poly32_hash_fn}) for name in sims.DEDUP_SCENARIOS]
    counted = data_plane_wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counted.values():
        k.launches = 0
    t0 = time.perf_counter()
    rows = []
    for label, fn, seed, kw in runs:
        c, cpu_s, cuda_s = sims.cuda_parity(fn, seed, **kw)
        rows.append({"scenario": label, "seed": seed, "steps": c.step_no,
                     "checks_run": c.checker.checks_run, "cpu_s": cpu_s, "cuda_s": cuda_s})
        del c
    launches = {name: k.launches for name, k in counted.items()}
    rep = {"runs": rows, "launches": launches, "phase_wall_s": time.perf_counter() - t0,
           "cpu_s": sum(r["cpu_s"] for r in rows), "cuda_s": sum(r["cuda_s"] for r in rows),
           "steps": sum(r["steps"] for r in rows),
           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"sim: {idle} never launched on the card; launches {launches}")
    return rep


def log_sim(rep: dict, card: str) -> None:
    slow = sorted(rep["runs"], key=lambda r: -r["cuda_s"])[:3]
    log(f"  [{card}] {len(rep['runs'])} scenario runs, each on the card and on the CPU with "
        f"equal traces, events, restored ledgers, catalogs (checksum tables included), free "
        f"lists and fault stats; "
        f"{rep['steps']} steps on the card; walls cuda {rep['cuda_s']:.2f} s, cpu "
        f"{rep['cpu_s']:.2f} s, phase {rep['phase_wall_s']:.2f} s")
    log(f"  [{card}] slowest on the card: "
        + ", ".join(f"{r['scenario']} {r['cuda_s']:.2f} s ({r['steps']} steps)" for r in slow))
    log(f"  [{card}] launches {rep['launches']}; peak device memory "
        f"{rep['peak_mem_bytes'] / 2**30:.3f} GiB")


def restore_launches(scatter_stats: dict, queued: int, walks: int, flushes: int) -> int:
    """``fused_restore`` launches of one restore: a direct install a batch
    that was not queued, a verify-only launch a batched walk, a launch a
    flush of its queued rows."""
    return scatter_stats["batches"] - queued + walks + flushes


def recurate_phase(torch, np, image, working_set, cold_idx, seed: int) -> dict:
    """Heat-driven re-curation at the 1.5 GiB image on the card: publish, two
    restores that each touch the same seeded half of the hot set through
    ``touch_pages`` and the same seeded cold pages through ``access``,
    ``PoolMaster.recurate`` (one fused publish of version 1), version 1
    restored bit-identically, delete and gc."""
    import threading

    from repro_torch.core import HeatRegistry, HierarchicalPool, Orchestrator, PoolMaster, \
        RestoreEngine
    from repro_torch.kernels.snapshot_fuse import ops

    name = "recurate"
    counted = data_plane_wrappers()
    rng = np.random.default_rng(seed + 31)
    traced = rng.choice(cold_idx, RECURATE_TOUCHES, replace=False)
    used = np.sort(rng.choice(working_set, working_set.size // 2, replace=False))
    threads_before = set(threading.enumerate())
    torch.cuda.synchronize()
    for k in counted.values():
        k.launches = 0
    t_phase = time.perf_counter()
    pool = HierarchicalPool(device=image.buf.device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    heat = HeatRegistry(clock=pool.clock, half_life_s=1e6)
    master = PoolMaster(pool, heat=heat, publish_fn=ops.make_fused_publish_fn())
    v0 = master.publish(name, image, working_set)
    orch = Orchestrator("recurate-host", pool, master.catalog, heat=heat)
    want_restore, restores = 0, []
    n_chunks0 = -(-v0.n_hot // RestoreEngine.HOT_CHUNK_PAGES)
    for _ in range(2):
        orch.scatter_fn = ops.FusedScatter()
        t0 = time.perf_counter()
        ri = orch.restore(name)
        touched = ri.engine.touch_pages(used)
        for p in traced.tolist():
            ri.engine.access(p, timeout_s=120.0)
        restores.append({"wall_s": time.perf_counter() - t0,
                         "fault_rdma": ri.instance.stats["fault_rdma"]})
        if touched != {"present": used.size, "faulted": 0}:
            raise AssertionError(f"recurate: touches of the hot set {touched}")
        check_routes("recurate restore", ri.engine.walk_routes, walks=1)
        want_restore += restore_launches(ri.instance.scatter_fn.stats, n_chunks0, 1,
                                         ri.instance.flushes)
        ri.shutdown()
    counts = heat.find(name, 0).counts()
    want_promote = np.sort(traced[counts[traced] >= 1.0])
    want_demote = np.setdiff1d(working_set, used)

    # recurate, with the plan it applies taken from its own "planned" step
    planned = {}

    def steps():
        for kind, val in master.recurate_steps(name):
            if kind == "planned":
                planned["plan"], planned["econ"] = val
                planned["s"] = time.perf_counter() - t0
            yield kind, val

    t0 = time.perf_counter()
    v1 = master._drive_steps(steps(), name, 30.0)
    torch.cuda.synchronize()
    recurate_s = time.perf_counter() - t0
    plan, econ = planned["plan"], planned["econ"]
    if not np.array_equal(np.sort(plan.promote), want_promote):
        raise AssertionError(f"recurate: promote {plan.promote.size} pages, want the "
                             f"{want_promote.size} traced cold pages at heat >= 1")
    if not np.array_equal(plan.demote, want_demote):
        raise AssertionError(f"recurate: demote {plan.demote.size} pages, want the "
                             f"{want_demote.size} hot pages no restore touched")
    if not np.array_equal(plan.new_working_set, np.union1d(used, want_promote)):
        raise AssertionError(f"recurate: the new hot set {plan.summary()} is not the touched "
                             "hot pages and the promoted ones")
    if v1 is None or v1.version != 1 or v1.n_hot != plan.n_hot_after:
        raise AssertionError(f"recurate: rebuilt {v1 and v1.to_dict()}, want version 1 with "
                             f"{plan.n_hot_after} hot pages ({econ})")
    orch.scatter_fn = ops.FusedScatter()
    ri = orch.restore(name)
    ri.engine.install_all_sync()
    torch.cuda.synchronize()
    if ri.borrow.version != 1 or not torch.equal(ri.instance.image.buf, image.buf):
        raise AssertionError("recurate: the restore of version 1 differs from the image")
    verified = ri.instance.scatter_fn.stats["pages_verified"]
    if verified != v1.n_hot + v1.n_cold:
        raise AssertionError(f"recurate: {verified} pages of version 1 verified")
    check_routes("recurate version-1 restore", ri.engine.walk_routes)
    cold_ext = sum(1 for _ in ri.engine.reader.iter_cold_extents(max_extent_pages=1 << 30))
    want_restore += restore_launches(
        ri.instance.scatter_fn.stats, -(-v1.n_hot // RestoreEngine.HOT_CHUNK_PAGES) + cold_ext,
        2, ri.instance.flushes)
    ri.shutdown()
    del ri
    launches = {n: k.launches for n, k in counted.items()}
    want = {"fused_publish": 2, "fused_restore": want_restore,
            **dict.fromkeys(ROW_KERNELS, 0)}
    if launches != want:
        raise AssertionError(f"recurate: launches {launches}, want {want}")
    if not master.delete(name) or master.gc() != 0 or \
            (pool.cxl.free_list(), pool.rdma.free_list()) != free0:
        raise AssertionError("recurate: delete + gc did not return the pool to its start")
    orch.close()
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"recurate: threads left after the phase: {left}")
    rep = {"n_hot_v0": v0.n_hot, "n_cold_v0": v0.n_cold, "n_hot_v1": v1.n_hot,
           "n_cold_v1": v1.n_cold, "hot_touched": int(used.size),
           "traced": RECURATE_TOUCHES, "restores": restores, "plan": plan.summary(),
           "economics": econ, "recurate_s": recurate_s, "planned_s": planned["s"],
           "launches": launches, "phase_wall_s": time.perf_counter() - t_phase}
    log(f"  two restores touching {used.size} seeded hot pages and {RECURATE_TOUCHES} seeded "
        "cold pages each: "
        + ", ".join(f"{r['wall_s']:.3f} s ({r['fault_rdma']} cold faults)" for r in restores))
    log(f"  plan {rep['plan']}; promote = the traced pages at heat >= 1, demote = the "
        "untouched hot pages")
    log(f"  recuration_economics (paper cost model, not device time): {json.dumps(econ)}")
    log(f"  recurate: planned in {planned['s']:.3f} s (fit_prefetch_model, plan, reconstruct; "
        f"host), version 1 in {recurate_s * 1e3:.1f} ms wall, n_hot {v0.n_hot} -> {v1.n_hot}; "
        f"version 1 restored bit-identically, every page verified; launches {launches}; "
        f"pool back to its start; phase {rep['phase_wall_s']:.2f} s")
    return rep


def json_leaves(d) -> int:
    return sum(json_leaves(v) for v in d.values()) if isinstance(d, dict) else 1


def check_launches(where: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{where}: launches {got}, want {want}")


def fleet_reference(torch, fb, device, full: bool = False) -> dict:
    """(a): the bench twin's single-pod and multi-pod runs at the
    reference's quick configurations (``full``: its full ones) with every pod
    on the card, each held key for key against the JAX package's committed
    JSON file."""
    wrappers = data_plane_wrappers()
    for k in wrappers.values():
        k.launches = 0
    rep = {"walls_s": {}, "keys_compared": {}}
    outs = {}
    suffix = ".json" if full else "_quick.json"
    for fn, name in (("run", f"fleet_bench{suffix}"),
                     ("run_multipod", f"fleet_bench_multipod{suffix}")):
        walls = {}
        t0 = time.perf_counter()
        out = json.loads(json.dumps(getattr(fb, fn)(quick=not full, device=device,
                                                    walls=walls)))
        walls["total"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        want = json.loads((ROOT / "experiments" / name).read_text())
        diffs, _, _, inexact = json_close(out, want)
        diff = diffs + inexact
        if diff:
            raise AssertionError(f"fleet {fn}: differs from experiments/{name}: {diff[:8]}")
        if not all(out["criteria"].values()):
            raise AssertionError(f"fleet {fn}: criteria {out['criteria']}")
        rep["walls_s"][fn] = walls
        rep["keys_compared"][name] = json_leaves(want)
        outs[fn] = out
    launches = {n: k.launches for n, k in wrappers.items()}
    publishes = outs["run"]["fleet"]["n_types"] + outs["run_multipod"]["fleet"]["n_types"]
    restores = (outs["run"]["pod"]["restores_verified"]
                + outs["run_multipod"]["fleet"]["restores_verified"])
    # a publish: the admission estimate's zero scan and hot gather, the fused
    # sweep, one store write a tier; a restore: one batched walk a tier
    want = {"fused_publish": publishes, "fused_restore": 0, "zero_detect": publishes,
            "page_checksum": 0, "page_gather": publishes,
            "page_scatter": 2 * publishes + 2 * restores}
    check_launches("fleet (a)", launches, want)
    rep["launches"] = launches
    rep["policies"] = {p: {k: s[k] for k in ("p50_cold_start_s", "p99_cold_start_s")}
                       for p, s in outs["run"]["policies"].items()}
    rep["tiers"] = {t: {k: s[k] for k in ("p50_cold_start_s", "p99_cold_start_s")}
                    for t, s in outs["run_multipod"]["tiers"].items()}
    rep["invocations"] = {fn: o["fleet"]["invocations"] for fn, o in outs.items()}
    for fn, walls in rep["walls_s"].items():
        log(f"  (a) {fn}: {', '.join(f'{k} {v:.2f} s' for k, v in walls.items())}")
    for p, s in rep["policies"].items():
        log(f"  (a) {p:>12}: p50 {s['p50_cold_start_s'] * 1e3:.3f} ms, p99 "
            f"{s['p99_cold_start_s'] * 1e3:.3f} ms (modeled)")
    for t, s in rep["tiers"].items():
        log(f"  (a) {t:>14}: p50 {s['p50_cold_start_s'] * 1e3:.3f} ms, p99 "
            f"{s['p99_cold_start_s'] * 1e3:.3f} ms (modeled)")
    log(f"  (a) every key equal to the committed files ({rep['keys_compared']}), all criteria "
        f"true, {rep['invocations']} invocations; launches {launches}")
    return rep


def fleet_scale(torch, np, fb, device, seed: int) -> dict:
    """(b): the full configuration's 200 function types with each variant's
    pages ``FLEET_SCALE_X`` times the bench's, published into one dedup pod on the
    card, profiled, 8 of them restored verified, I6, the locality drive over
    the full trace, then every variant deleted and the pool back to zero."""
    from repro_torch import core
    from repro_torch.fleet import generate_trace, synthesize_fleet
    from repro_torch.kernels import FusedScatter

    c = fb.bench_config(quick=False)
    hot, cold, zero, delta = (c[k] * FLEET_SCALE_X for k in ("hot", "cold", "zero", "delta"))
    fleet = synthesize_fleet(c["n_types"], c["n_bases"], c["total_rps"], seed=fb.SEED,
                             compute_mean_s=c["compute_mean"])
    wrappers = data_plane_wrappers()
    for k in wrappers.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    rep = {"scale_x": FLEET_SCALE_X, "n_variants": len(fleet),
           "pages_per_variant": {"hot": hot, "cold": cold, "zero": zero, "delta": delta}}
    t0 = time.perf_counter()
    pool, master, pub = fb.build_scale_pod(fleet, hot, cold, zero, delta, seed=seed,
                                           device=device)
    rep["publish_s"] = time.perf_counter() - t0
    decide = pool.dedup_cxl.decide_s + pool.dedup_rdma.decide_s
    rep["publish_wall_ms"] = {"p50": _pct(np, pub, 50), "max": max(pub) * 1e3,
                              "sum_s": sum(pub)}
    rep["decide_s"] = decide
    rep["decide_share"] = decide / sum(pub)
    rep["pool_bytes"] = {"cxl": pool.cxl.bytes_in_use, "rdma": pool.rdma.bytes_in_use}
    t0 = time.perf_counter()
    profiles, err = fb.profile_pod(pool, master, fleet)    # isclose at conc 1 and 4
    rep["profile_s"] = time.perf_counter() - t0
    rep["restores"] = []
    t0 = time.perf_counter()
    for i in fb.sample_ids(fleet, c["n_sample"]):
        f = fleet[i]
        borrow = master.catalog.borrow(f.name)
        try:
            img = fb.scale_image(f, hot, cold, zero, delta, seed, device)
            r = restore_once(torch, pool, borrow.regions, img.buf, img.manifest, FusedScatter())
            check_routes(f"fleet (b) {f.name}", r["walk_routes"])
            if r["pages_verified"] != borrow.regions.n_hot + borrow.regions.n_cold:
                raise AssertionError(f"fleet (b) {f.name}: {r['pages_verified']} verified")
            rep["restores"].append({"fn": f.name, "restore_s": r["restore_s"],
                                    "pages_verified": r["pages_verified"]})
            del img, r
        finally:
            borrow.release()
    rep["restores_s"] = time.perf_counter() - t0
    regions = [master.catalog.find(f.name).regions for f in fleet]
    if not i6_holds(np, core, pool, regions):
        raise AssertionError("fleet (b) I6: store refcounts differ from the live offset arrays")
    torch.cuda.synchronize()
    rep["peak_mem_above_start_bytes"] = torch.cuda.max_memory_allocated() - base_mem
    launches = {n: k.launches for n, k in wrappers.items()}
    n = len(fleet)
    want = {"fused_publish": n, "fused_restore": 4 * c["n_sample"], "zero_detect": n,
            "page_checksum": 0, "page_gather": n, "page_scatter": 2 * n}
    check_launches("fleet (b)", launches, want)
    rep["launches"] = launches
    del regions
    fb.free_pod(master)
    if pool.cxl.bytes_in_use or pool.rdma.bytes_in_use or pool.dedup_cxl.refcounts() \
            or pool.dedup_rdma.refcounts():
        raise AssertionError(f"fleet (b): pool not back to zero: cxl {pool.cxl.bytes_in_use} "
                             f"rdma {pool.rdma.bytes_in_use}")
    del pool, master
    torch.cuda.empty_cache()
    # the locality policy over the first FLEET_DRIVE_SHARE of the full
    # configuration's trace span, the profiles extrapolated to the bench's hot bytes
    x = c["target_hot"] / (hot * PAGE)
    trace = generate_trace(fleet, c["t_end"] * FLEET_DRIVE_SHARE, seed=fb.SEED)
    t0 = time.perf_counter()
    res = fb.drive(fleet, {k: p.scaled(x) for k, p in profiles.items()}, trace, "locality",
                   c["n_hosts"], c["slots"], c["max_hosts"])
    rep["drive_s"] = time.perf_counter() - t0
    s = res.summary()
    if s["completed"] != s["invocations"]:
        raise AssertionError(f"fleet (b) drive: {s['completed']} of {s['invocations']} done")
    rep["extrapolated_x"] = x
    rep["summary"] = s
    return rep


def fleet_a4d(torch, image, working_set) -> dict:
    """(c): the 1.5 GiB image published with ``compress_cold=True`` and
    without it, each into a fresh pool through the fused sweep.  Without
    ``zstandard`` the first must be the second (the reference's rule); with
    it, the compressed snapshot restores bit-identically, every page
    verified."""
    import dataclasses

    from repro_torch import core
    from repro_torch.core import snapshot as snap
    from repro_torch.kernels import FusedScatter, make_fused_publish_fn

    wrappers = data_plane_wrappers()
    for k in wrappers.values():
        k.launches = 0
    pools, regs, walls = [], [], []
    for compress in (True, False):
        pool = core.HierarchicalPool(device=image.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regs.append(core.build_snapshot(pool, image, working_set, "z", compress_cold=compress,
                                        publish_fn=make_fused_publish_fn()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        pools.append(pool)
    rep = {"zstandard": snap._zstd is not None, "publish_s": walls,
           "cold_compressed": regs[0].cold_compressed}
    want = dict.fromkeys(DATA_PLANE, 0) | {"fused_publish": 2}
    if snap._zstd is None:
        same = (dataclasses.asdict(regs[0]) == dataclasses.asdict(regs[1])
                and torch.equal(pools[0].cxl.buf, pools[1].cxl.buf)
                and torch.equal(pools[0].rdma.buf, pools[1].rdma.buf))
        if regs[0].cold_compressed or not same:
            raise AssertionError("fleet (c): compress_cold without zstandard is not the "
                                 "uncompressed publish")
        log("  (c) zstandard is not installed here: compress_cold=True published the 1.5 GiB "
            "image uncompressed (cold_compressed=False), regions and tier bytes equal to the "
            "uncompressed publish; the zstd branches were not driven")
    else:
        r = restore_once(torch, pools[0], regs[0], image.buf, image.manifest, FusedScatter())
        if r["pages_verified"] != regs[0].n_hot + regs[0].n_cold:
            raise AssertionError(f"fleet (c): {r['pages_verified']} pages verified")
        want["fused_restore"] = 4
        rep["ratio"] = regs[0].cold_raw_bytes / regs[0].cold_bytes
        rep["restore_s"] = r["restore_s"]
        log(f"  (c) compressed cold tier: ratio {rep['ratio']:.3f} "
            f"({regs[0].cold_raw_bytes} -> {regs[0].cold_bytes} B), restored bit-identically "
            f"in {r['restore_s']:.2f} s, every page verified")
    launches = {n: k.launches for n, k in wrappers.items()}
    check_launches("fleet (c)", launches, want)
    rep["launches"] = launches
    return rep


def log_fleet_scale(b: dict, target_hot: int, a_p99: float) -> None:
    """(b)'s lines: the cut, the publishes, profiles and restores, the drive."""
    pv = b["pages_per_variant"]
    s = b["summary"]
    log(f"  (b) cut: {pv['hot']} hot pages ({pv['hot'] * PAGE >> 20} MiB) a variant against the "
        f"bench's {target_hot >> 20} MiB target ({b['scale_x']}x "
        f"the bench's pages; profiles extrapolated {b['extrapolated_x']:g}x for the drive)")
    log(f"  (b) {b['n_variants']} variants published in "
        f"{b['publish_s']:.2f} s: per variant p50 {b['publish_wall_ms']['p50']:.2f} ms, max "
        f"{b['publish_wall_ms']['max']:.2f} ms wall; host decision share "
        f"{b['decide_share']:.3f} ({b['decide_s']:.2f} s); pool cxl "
        f"{b['pool_bytes']['cxl'] / 2**30:.3f} GiB rdma {b['pool_bytes']['rdma'] / 2**30:.3f} GiB")
    walls = ", ".join(f"{r['restore_s'] * 1e3:.1f}" for r in b["restores"])
    log(f"  (b) profiles exact at conc 1 and 4 in {b['profile_s']:.2f} s; "
        f"{len(b['restores'])} restores bit-identical, every page verified, in "
        f"{b['restores_s']:.2f} s ({walls} ms); I6 holds; launches {b['launches']}; "
        "pool back to zero")
    log(f"  (b) locality drive {b['drive_s']:.2f} s: p50 {s['p50_cold_start_s'] * 1e3:.3f} ms, "
        f"p99 {s['p99_cold_start_s'] * 1e3:.3f} ms (modeled, {b['extrapolated_x']:g}x); (a)'s "
        f"locality p99 {a_p99 * 1e3:.3f} ms; printed, not compared: the two extrapolate "
        "different layouts")


def fleet_phase(torch, np, image, working_set, seed: int, out_dir: Path,
                full: bool = False) -> dict:
    """The fleet phase: (a), (b) and (c) above, counts reset before each
    part; the bench twin's JSON files go to ``out_dir``/fleet_bench.  (a)
    runs the quick configurations unless ``full``.  Returns the phase's
    numbers."""
    import threading

    import fleet_bench as fb

    threads_before = set(threading.enumerate())
    fb.OUT = out_dir / "fleet_bench"
    device = image.device
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rep = {"a": fleet_reference(torch, fb, device, full)}
    rep["a_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep["b"] = b = fleet_scale(torch, np, fb, device, seed)
    rep["b_s"] = time.perf_counter() - t0
    log_fleet_scale(b, fb.bench_config(quick=False)["target_hot"],
                    rep["a"]["policies"]["locality"]["p99_cold_start_s"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep["c"] = fleet_a4d(torch, image, working_set)
    rep["c_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"fleet: threads left after the phase: {left}")
    rep["launches"] = {n: rep["a"]["launches"][n] + b["launches"][n] + rep["c"]["launches"][n]
                       for n in DATA_PLANE}
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  fleet: (a) {rep['a_s']:.2f} s, (b) {rep['b_s']:.2f} s, (c) {rep['c_s']:.2f} s; "
        f"peak device memory {rep['peak_mem_bytes'] / 2**30:.3f} GiB ((b) "
        f"{b['peak_mem_above_start_bytes'] / 2**30:.3f} GiB above its start); launches "
        f"{rep['launches']}; no thread left")
    return rep


# -- the evaluation benches ----------------------------------------------------

# keys that are a relative difference of two quantities, compared on their scale, 1
RELATIVE_ERROR_KEYS = ("model_err_max",)


def json_close(got, want, path: str = "", skip=()) -> tuple:
    """Compare two JSON values key for key: ints, booleans and strings
    ``==``; floats ``==`` or within 1e-12 relative (1e-15 absolute under
    1e-12; 1e-12 absolute for a key in ``RELATIVE_ERROR_KEYS``); lists
    element by element.  A key named in ``skip`` or a path in it is not
    compared.  Returns ``(diffs, floats, floats_bit_equal, inexact)``,
    ``inexact`` the paths of floats that are close but not equal."""
    diffs, inexact, n = [], [], [0, 0]

    def walk(a, b, p):
        leaf = p.rsplit("/", 1)[-1]
        if leaf in skip or p in skip:
            return
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b), key=str):
                walk(a.get(k), b.get(k), f"{p}/{k}")
        elif isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{p}[{i}]")
        elif isinstance(a, float) and isinstance(b, float) and type(a) is type(b):
            n[0] += 1
            if a == b:
                n[1] += 1
            elif abs(a - b) <= (1e-12 if leaf in RELATIVE_ERROR_KEYS
                                else 1e-15 if abs(b) < 1e-12 else 1e-12 * abs(b)):
                inexact.append(f"{p}: {a!r} vs {b!r}")
            else:
                diffs.append(f"{p}: {a!r} != {b!r}")
        elif a != b or type(a) is not type(b):
            diffs.append(f"{p}: {a!r} != {b!r}")

    walk(got, want, path)
    return diffs, n[0], n[1], inexact


def bench_files(name: str, quick: bool) -> tuple:
    """The committed file a twin's run is held to, and its output's name."""
    out = f"{name}.json" if name in SINGLE_CONFIG or not quick else f"{name}_quick.json"
    return ROOT / "experiments" / "torch" / out, out


def brownout_rejection_bounds(n_restores: int, hot_pages: int) -> tuple:
    """The fault bench's brownout rejections, which follow the wall clock,
    bounded.  At least the trip a restore (a restore outlasts the breaker's
    2 ms cooldown); at most one rejection a host-link read that a restore
    makes while the breaker lets it through: its machine state and offset
    array, each hot chunk, each hot page (served degraded once rejected)."""
    from repro_torch.core.serving import RestoreEngine

    chunks = -(-hot_pages // RestoreEngine.HOT_CHUNK_PAGES)
    return n_restores, n_restores * (2 + chunks + hot_pages)


def bench_criteria(name: str, out: dict) -> dict:
    """The bench's pass/fail keys (each must be true)."""
    if name == "concurrency_bench":
        return {k: out["criteria"][k] for k in ("gain_ok", "model_within_15pct",
                                                "all_bit_identical")}
    if name == "breakdown":
        return {"restore_bit_identical": out["restore_bit_identical"]}
    if name == "serving_bench":
        return {"all_bit_identical_and_not_slower": out["all_bit_identical_and_not_slower"]}
    if name == "characterization":
        return {"kernel_bitmap_match": all(r["kernel_bitmap_match"] for r in out["rows"])}
    if name in ("runlength", "scalability"):     # modeled figures: held to their files only
        return {}
    return out["criteria"]


def bench_headline(name: str, out: dict) -> str:
    if name == "dedup_bench":
        return f"effective capacity {out['effective_capacity_x']:.4f}x (>= 1.5)"
    if name == "fault_bench":
        return "p50 " + ", ".join(f"{s} {r['p50_modeled_ms']:.6f} ms"
                                  for s, r in out["sweeps"].items()) + " (modeled)"
    if name == "adaptive_bench":
        return (f"recovery {out['adaptive']['recovery_x']:.4f}x (>= 1.3), prefetch stall cut "
                f"{out['prefetch_ab']['min_stall_reduction_x']:.4f}x")
    if name == "concurrency_bench":
        return f"gain at conc >= 8 {out['criteria']['gain_at_conc_ge_8']:.4f}x (>= 1.5)"
    if name == "breakdown":
        return (f"speedup over Firecracker {out['speedup_vs_firecracker']:.4f}x, over FaaSnap "
                f"{out['speedup_vs_faasnap']:.4f}x (modeled; paper 2.12x, 1.19x)")
    if name == "characterization":
        a = out["average"]
        return (f"zero {a['zero_frac']:.4f}, hot {a['hot_frac']:.4f}, cold of non-zero "
                f"{a['cold_frac_of_nonzero']:.4f} (paper 0.828, 0.055, 0.727); the kernel's "
                f"bitmap matches the host's on {len(out['rows'])} images")
    if name == "runlength":
        a = out["aggregate"]
        return (f"mean hot run {a['mean_run']:.4f} pages, {a['frac_runs_lt4']:.4f} of runs "
                f"under 4, {a['mean_runs_per_snapshot']:.1f} runs a snapshot (paper 5.0, 0.90, "
                f"4164.2)")
    if name == "scalability":
        g = out["geomean_speedups_at_32"]
        return (f"geomean speedup at 32 over Firecracker {g['vs_firecracker']:.4f}x, FaaSnap "
                f"{g['vs_faasnap']:.4f}x, REAP {g['vs_reap']:.4f}x (modeled; paper 2.2x, 1.3x, "
                f"1.1x)")
    if name == "kernel_bench":
        mo, me = out["modeled"], out["measured"]
        return (f"modeled at the H100 roof: publish {mo['publish']['speedup']:.4f}x, restore "
                f"{mo['restore']['speedup']:.4f}x; on this device at {me['n_pages']} pages: "
                f"fused publish {me['publish']['fused_steady_s'] * 1e3:.4f} ms "
                f"({me['publish']['speedup']:.3f}x piecemeal), fused restore of "
                f"{me['chunk_pages']} rows {me['restore']['fused_steady_s'] * 1e3:.4f} ms "
                f"({me['restore']['speedup']:.3f}x)")
    sp = [r["total_speedup"] for r in out["rows"]]
    return (f"{len(sp)} workloads: batched over per-page {min(sp):.4f}-{max(sp):.4f}x "
            f"(modeled), zstd_available {out['zstd_available']}")


def bench_twin(torch, name: str, quick: bool, out_dir: Path) -> dict:
    """One twin's run on the card, counts reset just before it, held to its
    committed CPU output (``breakdown`` also to the reference's file) with
    every criterion true and its launches as ``BENCH_LAUNCHES`` says."""
    import gc
    import importlib

    mod = importlib.import_module(name)
    mod.OUT = out_dir
    kw = {} if name in SINGLE_CONFIG else {"quick": quick}
    wrappers = data_plane_wrappers()
    for k in wrappers.values():
        k.launches = 0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = mod.run(device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in wrappers.items()}
    # a pool's objects (and a master's) reference each other: the arenas a
    # run allocated go with the cyclic collector, not when the run returns
    gc.collect()
    torch.cuda.empty_cache()
    out = json.loads(json.dumps(out))
    path, fname = bench_files(name, quick)
    written = json.loads((out_dir / fname).read_text())
    if written != out:
        raise AssertionError(f"benches {name}: the written file differs from the return value")
    # wall clocks; and the brownout's breaker rejections, which follow the wall clock (the
    # pool's breaker takes REAL_CLOCK): bounded below instead
    # kernel_bench's measured section is its device's times (its bit-identity is a criterion)
    # and its backend the device's name
    skip = ("wall_s", "/sweeps/brownout/total_injected", "/measured", "/config/backend")
    rep = {"wall_s": wall, "launches": launches, "compared": {},
           "mem_left_bytes": torch.cuda.memory_allocated() - mem0}
    wants = [(str(path.relative_to(ROOT)), json.loads(path.read_text()))]
    if name == "breakdown":
        wants.append(("experiments/breakdown.json",
                      json.loads((ROOT / "experiments" / "breakdown.json").read_text())))
    for src, want in wants:
        diffs, n_float, n_equal, inexact = json_close(out, want, skip=skip)
        if diffs:
            raise AssertionError(f"benches {name}: differs from {src}: {diffs[:8]}")
        rep["compared"][src] = {"keys": json_leaves(want), "floats": n_float,
                                "floats_bit_equal": n_equal, "inexact": inexact}
    if name == "fault_bench":
        b = out["sweeps"]["brownout"]
        lo, hi = brownout_rejection_bounds(b["n_restores"], out["workload"]["hot_pages"])
        if not lo <= b["total_injected"] <= hi:
            raise AssertionError(f"benches fault_bench: brownout rejections {b['total_injected']} "
                                 f"outside [{lo}, {hi}]")
        rep["brownout_injected"] = b["total_injected"]
    crit = bench_criteria(name, out)
    if not all(crit.values()):
        raise AssertionError(f"benches {name}: criteria {crit}")
    want_launches = dict.fromkeys(DATA_PLANE, 0) | BENCH_LAUNCHES[name][
        "quick" if quick and name not in SINGLE_CONFIG else "full"]
    check_launches(f"benches {name}", launches, want_launches)
    rep["headline"] = bench_headline(name, out)
    cmp = "; ".join(f"{src}: {c['floats_bit_equal']} of {c['floats']} floats bit-equal"
                    + (f", {len(c['inexact'])} within 1e-12: {c['inexact']}" if c["inexact"]
                       else "") for src, c in rep["compared"].items())
    log(f"  (a) {name}{' (quick)' if quick else ''}: {wall:.2f} s; {rep['headline']}; every "
        f"key held ({cmp}); criteria true; launches {launches}; device memory left "
        f"{rep['mem_left_bytes'] / 2**20:.1f} MiB")
    return rep


def fault_cell_launches(n_restores: int, n_hot: int, hot_extents: int, cold_runs: int) -> dict:
    """The launches of :func:`fault_cell` over a private snapshot with
    ``n_hot`` hot pages in ``hot_extents`` chunks and ``cold_runs`` cold
    runs: a fused sweep a stack (the bare run, four sweeps, the model, the
    extents' count); per restore, the bare run's two batched walks (a
    verify-only launch and an install each), and with an injector armed
    every walk per extent: a hot chunk or cold run a launch (none,
    rdma_timeouts; a timed-out read is re-issued before its install), two
    more for the poisoned page (the chunk's install, then the repaired
    page's), and under the brownout a demand fault a hot page."""
    per_extent = hot_extents + cold_runs
    return dict.fromkeys(DATA_PLANE, 0) | {
        "fused_publish": 7,
        "fused_restore": n_restores * (4 + 2 * per_extent + (per_extent + 2)
                                       + (n_hot + cold_runs))}


def fault_cell(torch, np, image, working_set, n_restores: int = 2) -> dict:
    """(b): the fault bench's bare run and four sweeps, ``n_restores``
    restores each, at cell (1)'s 1.5 GiB image, through the twin's own
    ``make_stack`` / ``run_sweep`` with its pool sized to the snapshot."""
    import fault_bench as fb

    from repro_torch.core import SnapshotReader, estimate_snapshot_cxl_size

    ws = working_set
    n_cold = int((image.pages_matrix().any(dim=1).cpu().numpy()).sum()) - len(ws)
    slack = 1 << 20
    cap = {"cxl_capacity": estimate_snapshot_cxl_size(image, ws) + slack,
           "rdma_capacity": n_cold * PAGE + slack}
    wrappers = data_plane_wrappers()
    for k in wrappers.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bare = fb.run_sweep("none", n_restores, image, ws, armed=False, **cap)
    sweeps = {s: fb.run_sweep(s, n_restores, image, ws, **cap) for s in fb.SWEEPS}
    model = fb.degraded_model_ms(image, ws, **cap)
    wall = time.perf_counter() - t0
    crit = fb.criteria_of(sweeps, bare, model, n_restores)
    if not all(crit.values()):
        raise AssertionError(f"benches (b): criteria {crit}")
    # the layout's extents: per-extent walks launch once an extent
    pool, master, borrow = fb.make_stack(image, ws, **cap)
    reader = SnapshotReader(borrow.regions, pool.host_view("count"), pool.rdma)
    n_hot, n_cold = borrow.regions.n_hot, borrow.regions.n_cold
    hot_ext = sum(1 for _ in reader.iter_hot_extents())
    cold_runs = int(reader.cold_runs().shape[0])
    del reader
    fb.free_stack(pool, master, borrow)
    del pool, master, borrow
    rows = {"bare": bare, **sweeps}
    for s, r in rows.items():
        if r["_pages_verified"] != [n_hot + n_cold] * n_restores or not r["all_bit_identical"]:
            raise AssertionError(f"benches (b) {s}: verified {r['_pages_verified']}, bit-identical "
                                 f"{r['all_bit_identical']}")
    b = sweeps["brownout"]
    if not (sweeps["rdma_timeouts"]["total_retries"] > 0
            and sweeps["cxl_poison"]["total_repairs"] == n_restores
            and b["n_degraded"] == n_restores):
        raise AssertionError(f"benches (b): retries/repairs/degraded {sweeps}")
    launches = {n: k.launches for n, k in wrappers.items()}
    check_launches("benches (b)", launches,
                   fault_cell_launches(n_restores, n_hot, hot_ext, cold_runs))
    torch.cuda.synchronize()
    rep = {"n_restores": n_restores, "n_hot": n_hot, "n_cold": n_cold, "hot_extents": hot_ext,
           "cold_runs": cold_runs, "capacity": cap, "wall_s": wall, "launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "peak_mem_above_start_bytes": torch.cuda.max_memory_allocated() - base_mem,
           "degraded_model": model, "criteria": crit,
           "sweeps": {s: {**fb.strip(r), "wall_s": r["_wall_s"]} for s, r in rows.items()}}
    for s, r in rows.items():
        log(f"  (b) {s:>13}: p50 {r['p50_modeled_ms']:.4f} ms modeled; restores "
            + ", ".join(f"{w:.3f}" for w in r["_wall_s"]) + " s wall; retries "
            f"{r['total_retries']}, repairs {r['total_repairs']}, degraded {r['n_degraded']}, "
            f"injected {r['total_injected']}")
    log(f"  (b) {n_restores} restores a sweep of the {image.total_pages}-page image (n_hot "
        f"{n_hot}, n_cold {n_cold}; {hot_ext} hot chunks, {cold_runs} cold runs): every restore "
        f"bit-identical, every page verified; armed-but-empty ledgers == bare (overhead 0); "
        f"brownout p50 {b['p50_modeled_ms']:.4f} ms against the degraded model "
        f"{model['degraded_ms']:.4f} ms (within 15%); every pool byte back; {wall:.2f} s; peak "
        f"device memory {rep['peak_mem_bytes'] / 2**30:.3f} GiB "
        f"({rep['peak_mem_above_start_bytes'] / 2**30:.3f} above the start); launches {launches}")
    return rep


def benches_phase(torch, np, image, working_set, out_dir: Path) -> dict:
    """The benches phase: (a) the ten twins of ``BENCHES`` at the
    reference's full configurations against their committed files, (b) the fault sweeps at
    cell (1)'s image; counts reset before each.  The twins' JSON files go
    to ``out_dir``/benches."""
    import threading

    from repro_torch.kernels.flash_attention import ops as flash_ops

    threads_before = set(threading.enumerate())
    flash_ops.reset_launches()   # the workloads only initialise parameters: no attention
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()
    rep = {"a": {}}
    for name in BENCHES:
        rep["a"][name] = bench_twin(torch, name, False, out_dir / "benches")
        torch.cuda.empty_cache()
    import gc

    import workloads

    rep["workload_images_bytes"] = sum(w.image.buf.numel() for w in workloads._cache.values())
    workloads.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    rep["a_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    rep["b"] = fault_cell(torch, np, image, working_set, FAULT_RESTORES)
    rep["b_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"benches: threads left after the phase: {left}")
    rep["launches"] = {n: sum(r["launches"][n] for r in rep["a"].values())
                       + rep["b"]["launches"][n] for n in DATA_PLANE}
    rep["launches_flash"] = flash_ops.flash_attention.launches
    if rep["launches_flash"]:
        raise AssertionError(f"benches: {rep['launches_flash']} flash_attention launches")
    rep["mem_left_bytes"] = torch.cuda.memory_allocated() - mem0
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  benches: the workloads' images, built once for the phase: "
        f"{rep['workload_images_bytes'] / 2**30:.3f} GiB on the card")
    log(f"  benches: (a) {rep['a_s']:.2f} s ("
        + ", ".join(f"{n} {r['wall_s']:.2f}" for n, r in rep["a"].items())
        + f"), (b) {rep['b_s']:.2f} s; launches {rep['launches']}; no thread left; device "
        f"memory left {rep['mem_left_bytes'] / 2**20:.1f} MiB")
    return rep


def serve_timed(torch, np, inst, prompts, n_new: int):
    """Greedy serving as ``ServerInstance.generate`` does it, prefill and
    decode timed apart: ``(tokens (B, n_new), prefill logits, last logits,
    prefill_s, decode_s)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_logits = inst.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    logits = pre_logits
    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out = []
    t0 = time.perf_counter()
    for _ in range(n_new):
        out.append(tok[:, 0].cpu().numpy())
        logits = inst.decode(tok)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    return np.stack(out, axis=1), pre_logits, logits, prefill_s, time.perf_counter() - t0


def check_sweep(torch, pm, zero, checksums, where: str, chunk: int = 1 << 18) -> int:
    """A kernel's zero flags (``zero``, bool[N]) and poly32 checksums
    (``checksums``, int32[N], or None) of the pages ``pm`` against the plain
    versions, ``chunk`` pages at a time so the plain versions' temporaries
    stay near a GiB on a full-size image; returns the largest absolute
    difference (0) and raises on any."""
    from repro_torch.kernels.page_checksum.ref import page_checksum_ref
    from repro_torch.kernels.zero_detect.ref import zero_detect_ref

    err = 0
    for r0 in range(0, pm.shape[0], chunk):
        rows = pm[r0:r0 + chunk]
        pairs = [(zero[r0:r0 + chunk].to(torch.int32), zero_detect_ref(rows))]
        if checksums is not None:
            pairs.append((checksums[r0:r0 + chunk], page_checksum_ref(rows)))
        for got, want in pairs:
            _require_equal(f"{where} (pages {r0}..{r0 + rows.shape[0]})", got, want)
        err = max(err, max_abs_err(pairs))
    return err


def meta_like(torch, tree):
    """``tree``'s structure with meta tensors of its leaves' shapes and
    dtypes: a restore template that holds no memory."""
    if isinstance(tree, dict):
        return {k: meta_like(torch, v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def check_regenerated(torch, cfg, seed: int, device, restored: dict, where: str) -> None:
    """Every restored array bit-equal to the parameters regenerated from
    ``seed`` (``restored``: ``flatten_state`` of the restored tree)."""
    from repro_torch.checkpoint.ckpt import flatten_state
    from repro_torch.models import build

    again = flatten_state({"params": build(cfg, device=device).init(seed)})
    bad = [n for n, t in again.items() if not torch.equal(restored[n], t)]
    if list(restored) != list(again) or bad:
        raise AssertionError(f"coldstart: the {where}'s arrays differ from the originals: "
                             f"{bad or list(restored)}")


def coldstart_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """Serverless cold start of Phi-4-mini 3.8B, at full width and
    ``COLDSTART_LAYERS`` of its layers, from the pool (see the module
    docstring): reference tokens, publish through ``save_checkpoint``, the
    five modeled strategies, ``SkeletonPool`` claim, ``restore_server`` with
    the cold tail prefetched, serving, a profiled second restore, bit
    identity against parameters regenerated from the seed, delete and gc."""
    import dataclasses
    import gc
    import threading

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as kmod
    from repro_torch.checkpoint.ckpt import (flatten_state, restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.base import get_config
    from repro_torch.core import (AccessRecorder, HierarchicalPool, Orchestrator, PoolMaster,
                                  RestoreEngine, StateImage, profile_invocations)
    from repro_torch.kernels.snapshot_fuse import ops
    from repro_torch.models import build
    from repro_torch.serve import new_instance
    from repro_torch.serve.coldstart import SkeletonPool, restore_server
    from repro_torch.serve.strategies import STRATEGIES, WorkloadSpec, run_strategy

    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=COLDSTART_LAYERS,
                              name=f"{MODEL_ARCH}-{COLDSTART_LAYERS}l")
    table = "params/embed/table"
    counted = data_plane_wrappers()
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "param_count": cfg.param_count()}
    threads_before = set(threading.enumerate())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    for k in counted.values():
        k.launches = 0
    t_phase = time.perf_counter()

    # 1. the reference: tokens served from the original parameters
    params = build(cfg, device=device).init(seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 29)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                            device=device)
    want_tokens, _pre, want_logits, _p, _d = serve_timed(
        torch, np, new_instance(cfg, params, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW,
                                device=device), prompts, SERVE_NEW)
    gc.collect()

    # 2. the working set: 16 profiled invocations of the compression workload's
    # shape, and one more invocation's touches for the modeled strategies
    t0 = time.perf_counter()
    manifest = StateImage.layout(flatten_state({"params": params}))

    def invocation(rec, i):
        r = np.random.default_rng((seed, i))
        toks = np.minimum(r.zipf(1.4, size=COLDSTART_PROMPT) - 1, cfg.vocab - 1)
        rec.touch_rows(table, np.unique(toks))
        for e in manifest.extents:
            if e.name != table:
                rec.touch_array(e.name)

    ws = profile_invocations(manifest, invocation, COLDSTART_INVOCATIONS,
                             name="compression").working_set
    rec = AccessRecorder(manifest)
    invocation(rec, COLDSTART_INVOCATIONS + 1)
    touched = rec.working_set()
    rep["profile_s"] = time.perf_counter() - t0

    template = meta_like(torch, {"params": params})

    # 3. publish through save_checkpoint into a pool sized to the composition
    slack = 256 << 20
    pool = HierarchicalPool(cxl_capacity=ws.size * PAGE + 8 * manifest.total_pages + slack,
                            rdma_capacity=(manifest.total_pages - ws.size) * PAGE + slack,
                            device=device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    fused = ops.make_fused_publish_fn()
    swept = {}

    def publish_fn(pages, ws_mask):
        out = fused(pages, ws_mask)
        swept["zero"], swept["checksums"] = out.zero_bitmap.clone(), out.checksums.clone()
        return out

    master = PoolMaster(pool, publish_fn=publish_fn)
    image, pub = save_checkpoint(master, COLDSTART_NAME, {"params": params}, step=0,
                                 working_set=ws, metadata={"arch": cfg.name})
    torch.cuda.synchronize()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    n_hot, n_cold, n_zero = pub["hot"], pub["cold"], pub["zero"]
    rep["composition"] = {"total_pages": pub["total_pages"], "hot": n_hot, "cold": n_cold,
                          "zero": n_zero, "hot_GiB": n_hot * PAGE / 2**30,
                          "cold_GiB": n_cold * PAGE / 2**30,
                          "image_GiB": pub["total_pages"] * PAGE / 2**30}
    rep["publish_s"] = pub["publish_s"]
    rep["tiers_GiB"] = {"cxl": pool.cxl.capacity / 2**30, "rdma": pool.rdma.capacity / 2**30}
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.param_count():,} float32 parameters; image {pub['total_pages']} pages "
        f"({rep['composition']['image_GiB']:.3f} GiB): hot {n_hot} "
        f"({rep['composition']['hot_GiB']:.3f} GiB), cold {n_cold} "
        f"({rep['composition']['cold_GiB']:.3f} GiB), zero {n_zero}; profiled in "
        f"{rep['profile_s']:.2f} s; save_checkpoint publish {pub['publish_s'] * 1e3:.1f} ms wall")
    if n_zero != 0 or n_hot != ws.size or n_cold != pub["total_pages"] - ws.size:
        raise AssertionError(f"coldstart: composition {pub} for a working set of {ws.size}")

    # 4. the paper's five restore configurations, modeled (not device time)
    spec = WorkloadSpec("compression", image, ws, touched, COLDSTART_COMPUTE_S)
    rep["strategies"] = {}
    for sname in STRATEGIES:
        b = run_strategy(sname, spec, concurrency=COLDSTART_CONC).breakdown()
        rep["strategies"][sname] = b
        log(f"  modeled {sname:11s} setup {b['setup']:.4f} s prefetch {b['prefetch']:.4f} s "
            f"install {b['exec_install']:.4f} s total {b['total']:.4f} s "
            f"(paper cost model at concurrency {COLDSTART_CONC}, not device time)")

    # the path's two sweeps of the full image against their plain versions:
    # the publish's zero flags and checksums, and the zero scan the
    # strategies classify by (one more launch, not counted as the path's)
    pm = image.pages_matrix()
    err = {"fused_publish": check_sweep(torch, pm, swept["zero"], swept["checksums"],
                                        "coldstart fused_publish zero flags and checksums")}
    n_zero_detect = kmod.zero_detect.launches
    zero = torch.from_numpy(image.zero_page_bitmap()).to(device)
    kmod.zero_detect.launches = n_zero_detect
    err["zero_detect"] = check_sweep(torch, pm, zero, None,
                                     "coldstart zero_page_bitmap (zero_detect)")
    rep["max_abs_err"] = err
    log(f"  at the image's {pm.shape[0]} pages: the publish's zero flags and checksums and "
        "zero_page_bitmap's zero_detect launch bit-equal to the plain versions")
    del spec, image, pm, swept, zero
    gc.collect()
    torch.cuda.empty_cache()
    peaks = {"publish": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()

    # 5.-7. claim a skeleton, warm-restore into it with the cold tail
    # prefetched, serve the same prompts
    sp = SkeletonPool(cfg, batch=SERVE_BATCH, max_len=SERVE_PROMPT + SERVE_NEW,
                      target_size=1, background=True, device=device)
    t0 = time.perf_counter()
    skeleton = sp.claim()
    rep["claim_s"] = time.perf_counter() - t0
    orch = Orchestrator("serve-host", pool, master.catalog, prefetch_cold=True,
                        scatter_fn=ops.FusedScatter())
    n_chunks = -(-n_hot // RestoreEngine.HOT_CHUNK_PAGES)
    t0 = time.perf_counter()
    out = restore_server(orch, COLDSTART_NAME, skeleton, template)
    torch.cuda.synchronize()
    rep["restore_server_s"] = time.perf_counter() - t0
    st = out["stats"]
    verified = orch.scatter_fn.stats["pages_verified"]
    check_routes("coldstart restore", st["walk_routes"], walks=1)
    if verified != n_hot + n_cold:
        raise AssertionError(f"coldstart: {verified} pages verified, want {n_hot + n_cold}")
    want_restore = restore_launches(orch.scatter_fn.stats, n_chunks, 1, st["flushes"])
    inst = out["instance"]
    tokens, _pre, logits, prefill_s, decode_s = serve_timed(torch, np, inst, prompts,
                                                            SERVE_NEW)
    logit_err = float((logits - want_logits).abs().max())
    if not np.array_equal(tokens, want_tokens):
        raise AssertionError(f"coldstart: the restored server gave other tokens "
                             f"(logits max abs difference {logit_err})")
    rep["restore"] = {"time_to_hot_s": st["time_to_hot_s"], "time_to_full_s": st["time_to_full_s"],
                      "instance": st["instance"], "flushes": st["flushes"],
                      "walk_routes": st["walk_routes"], "pages_verified": verified}
    rep["modeled_ledger_s"] = st["modeled"]
    rep["modeled_total_s"] = sum(st["modeled"].values())
    rep["serve"] = {"batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT, "new_tokens": SERVE_NEW,
                    "prefill_s": prefill_s, "decode_s": decode_s,
                    "decode_tokens_per_s": SERVE_BATCH * SERVE_NEW / decode_s,
                    "logits_max_abs_diff": logit_err, "tokens": tokens[:, :4].tolist()}
    log(f"  restore_server: time to hot {st['time_to_hot_s']:.3f} s, to full "
        f"{st['time_to_full_s']:.3f} s ({st['instance']['fault_rdma']} cold faults, "
        f"{st['flushes']} flushes of the hot walk); SkeletonPool claim "
        f"{rep['claim_s'] * 1e3:.3f} ms; pages verified {verified}")
    log(f"  served {SERVE_BATCH} x {SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens: "
        f"prefill {prefill_s:.3f} s, decode {decode_s:.3f} s "
        f"({rep['serve']['decode_tokens_per_s']:.1f} tokens/s); the same tokens as before the "
        f"publish; last logits max abs difference {logit_err}")
    log(f"  modeled ledger of the restore (paper cost model, not device time): "
        f"{rep['modeled_total_s'] * 1e3:.4f} ms {json.dumps(st['modeled'])}")

    peaks["restore_and_serve"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # 8.-9. every restored array against the parameters regenerated from the seed
    restored = flatten_state(out["state"])
    del out, inst, skeleton
    gc.collect()
    torch.cuda.empty_cache()
    check_regenerated(torch, cfg, seed, device, restored, "restore")
    del restored
    gc.collect()
    torch.cuda.empty_cache()

    # a second restore of the same snapshot under torch.profiler (device
    # activity only): the device's idle share over a restore
    orch.scatter_fn = ops.FusedScatter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state2, st2 = restore_checkpoint(orch, COLDSTART_NAME, template)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["profile_restore"] = _device_summary(torch, prof, wall2,
                                             table=out_dir / "profile_coldstart_restore.txt")
    rep["profile_restore"]["post_processing_s"] = time.perf_counter() - t0
    del prof
    gc.collect()
    torch.cuda.empty_cache()
    check_regenerated(torch, cfg, seed, device, flatten_state(state2), "profiled restore")
    check_routes("coldstart profiled restore", st2["walk_routes"], walks=1)
    want_restore += restore_launches(orch.scatter_fn.stats, n_chunks, 1, st2["flushes"])
    rep["restore_profiled"] = {"time_to_hot_s": st2["time_to_hot_s"],
                               "time_to_full_s": st2["time_to_full_s"]}
    p = rep["profile_restore"]
    log(f"  profiled second restore: time to hot {st2['time_to_hot_s']:.3f} s, to full "
        f"{st2['time_to_full_s']:.3f} s; device busy {p['device_busy_ms']:.3f} ms of "
        f"{p['wall_ms']:.1f} ms, idle share {p['device_idle_share']:.4f} "
        f"(profiler post-processing {p['post_processing_s']:.1f} s)")
    for r in p["top"][:4]:
        log(f"    {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    del state2
    gc.collect()
    torch.cuda.empty_cache()

    launches = {n: k.launches for n, k in counted.items()}
    want = {"fused_publish": 1, "fused_restore": want_restore,
            "zero_detect": len(STRATEGIES), "page_checksum": 0, "page_gather": 0,
            "page_scatter": 0}
    if launches != want:
        raise AssertionError(f"coldstart: launches {launches}, want {want}")
    rep["launches"] = launches

    # close the skeleton pool and the node server; delete: every byte back
    sp.close()
    orch.close()
    if not master.delete(COLDSTART_NAME) or master.gc() != 0 or \
            (pool.cxl.free_list(), pool.rdma.free_list()) != free0:
        raise AssertionError("coldstart: delete + gc did not return the pool to its start")
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"coldstart: threads left after the phase: {left}")
    peaks["checks_and_profiled_restore"] = torch.cuda.max_memory_allocated()
    rep["peak_mem_bytes_by_part"] = peaks
    rep["peak_mem_bytes"] = max(peaks.values())
    rep["peak_mem_above_start_bytes"] = rep["peak_mem_bytes"] - base_mem
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  peak device memory {rep['peak_mem_bytes'] / 2**30:.3f} GiB "
        f"({rep['peak_mem_above_start_bytes'] / 2**30:.3f} above the phase's start; by part "
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in peaks.items()) + " GiB); "
        f"launches {launches}; skeleton pool closed, no thread left, pool back to its start")
    return rep


def flash_pairs(b: int, hq: int, sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the attention computes: suffix-aligned causal rows
    see i + Skv - Sq + 1 keys."""
    if not causal:
        return b * hq * sq * skv
    off = skv - sq
    return b * hq * (sq * (off + 1) + sq * (sq - 1) // 2)


def flash_bound_ms(q, k, v, causal: bool):
    """Least time for one call: 2*(Dk+Dv) operations per (query, key) pair at
    the peak rate for the inputs' type (bf16: tensor cores; float32: CUDA
    cores, as its float32 semantics rule out TF32), against q, k, v read and
    the output written once at the memory rate."""
    import torch

    b, hq, sq, dk = q.shape
    skv, dv = k.shape[2], v.shape[3]
    ops = 2 * (dk + dv) * flash_pairs(b, hq, sq, skv, causal)
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    nbytes = (q.numel() + k.numel() + v.numel() + b * hq * sq * dv) * q.element_size()
    t, by = bound_ms(nbytes, 0)
    if ops / rate * 1e3 > t:
        t, by = ops / rate * 1e3, "operations"
    return t, by, ops, nbytes


def _cuobjdump():
    import shutil

    tool = Path("/usr/local/cuda/bin/cuobjdump")
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


_DUMPS: dict = {}


def _dump(lib_path: Path, flag: str):
    """``cuobjdump <flag>`` of the library, run once a library a process;
    None where the toolkit has no ``cuobjdump``."""
    key = (str(lib_path), flag)
    if key not in _DUMPS:
        tool = _cuobjdump()
        _DUMPS[key] = None if tool is None else subprocess.run(
            [tool, flag, str(lib_path)], capture_output=True, text=True, timeout=120).stdout
    return _DUMPS[key]


def sass_counts(lib_path: Path) -> dict:
    """How many HGMMA (wgmma) and UTMALDG (TMA load) instructions the
    library's SASS holds, where the toolkit has ``cuobjdump``."""
    sass = _dump(lib_path, "-sass")
    if sass is None:
        return {"cuobjdump": None}
    return {"cuobjdump": _cuobjdump(), "HGMMA": sass.count("HGMMA"),
            "UTMALDG": sass.count("UTMALDG")}


def res_usage(lib_path: Path, functions: tuple, sass: bool = False) -> dict:
    """For each kernel whose mangled name holds one of ``functions``: its
    registers, stack, local (spill) and shared bytes, as ``cuobjdump
    -res-usage`` reads them, and with ``sass`` its HGMMA and UTMALDG counts."""
    import re

    res = _dump(lib_path, "-res-usage")
    if res is None:
        return {"cuobjdump": None}
    code = {}
    if sass:
        code = {part.split(None, 1)[0]: part
                for part in _dump(lib_path, "-sass").split("Function : ")[1:]}
    out = {}
    for fn in functions:
        at = res.find(fn)
        m = re.search(r"REG:\d+[^\n]*", res[at:]) if at >= 0 else None
        if m is None:
            raise AssertionError(f"cuobjdump -res-usage lists no kernel named {fn}")
        out[fn] = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", m.group(0))}
        if sass:
            text = next((part for name, part in code.items() if fn in name), None)
            if text is None:
                raise AssertionError(f"cuobjdump -sass lists no kernel named {fn}")
            out[fn].update(HGMMA=text.count("HGMMA"), UTMALDG=text.count("UTMALDG"))
    return out


def tensor_cores_no_spill(lib: str, functions: tuple, new: tuple) -> dict:
    """``res_usage`` of ``functions`` in library ``lib`` with their SASS
    counts; raises unless each of ``new`` has HGMMA instructions and no local
    bytes."""
    from repro_torch.kernels import build

    out = res_usage(build.lib_path(lib), functions, sass=True)
    if "cuobjdump" in out:
        raise AssertionError(f"{lib}: no cuobjdump to read the kernels' spills")
    for fn in new:
        if out[fn]["LOCAL"] != 0 or out[fn]["HGMMA"] == 0:
            raise AssertionError(f"{lib} {fn}: {out[fn]}, want no local bytes and HGMMA > 0")
    log(f"  {lib} kernels by (Dk, Dv): {out}")
    return out


def check_flash(torch, device, seed: int) -> dict:
    """Flash attention against its plain versions on the card, each case on
    the route ``ops.route`` gives it (asserted, by the rule and by the launch
    counts): the prefill path's shape (B=1, Hq=24, Hkv=8, S=8192, D=128,
    causal) in bf16 and float32, one tile, keys not a multiple of 128, a
    ragged Sq=1000 < Skv=1500 case, Dk != Dv and non-causal ones.  Then, at
    the prefill shape in bf16 and in turns, CUDA-event times of the
    tensor-core kernel, the SIMT kernel on the same inputs and the library
    call, beside the plain version and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, chunked_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops

    g = torch.Generator(device=device)
    g.manual_seed(seed + 17)

    def qkv(b, hq, hkv, sq, skv, dk, dv, dtype):
        return (torch.randn(b, hq, sq, dk, generator=g, device=device).to(dtype),
                torch.randn(b, hkv, skv, dk, generator=g, device=device).to(dtype),
                torch.randn(b, hkv, skv, dv, generator=g, device=device).to(dtype))

    # The reference runs in float32 on the inputs upcast, so it carries no
    # bf16 rounding: float32 output within 1e-5 (summation order), bf16
    # output within one round-to-nearest of it, |got - want| <= 2^-8 |want|
    # + 1e-4.  Truncating, computing in bf16, rounding P to bf16 or TF32 for
    # the P.V product, or losing 1% of a tile fails.
    tol = {torch.float32: {"rtol": 1e-5, "atol": 1e-5},
           torch.bfloat16: {"rtol": 2.0 ** -8, "atol": 1e-4}}

    def share_of(got, want, dtype):
        t = tol[dtype]
        err = (got.float() - want).abs()
        return float(err.max()), float((err / (t["atol"] + t["rtol"] * want.abs())).max())

    def check(name, got, want, dtype):
        """``want``: float32 from the upcast inputs.  Returns (max abs error,
        worst share of the limit)."""
        err, share = share_of(got, want, dtype)
        if got.dtype != dtype or got.shape != want.shape or share > 1:
            raise AssertionError(f"flash_attention ({name}) differs from its float32 plain "
                                 f"version: max_abs_err {err}, {share:.3f} of "
                                 f"the limit {tol[dtype]}")
        return err, share

    bf, f32 = torch.bfloat16, torch.float32
    path = (1, 24, 8, PREFILL_SEQ, PREFILL_SEQ, 128, 128)
    cases = [("path shape bf16", path, bf, True, "sm90"),
             ("path shape f32", path, f32, True, "simt"),
             ("one tile Sq=Skv=128", (1, 24, 8, 128, 128, 128, 128), bf, True, "sm90"),
             ("Skv=1100, not a multiple of 128", (2, 24, 8, 700, 1100, 128, 128), bf, True,
              "sm90"),
             ("ragged Sq=1000<Skv=1500", (1, 24, 8, 1000, 1500, 128, 128), bf, True, "sm90"),
             ("ragged f32, Dk=192 Dv=128", (2, 6, 2, 333, 517, 192, 128), f32, True, "simt"),
             ("non-causal", (1, 24, 8, 1000, 1500, 128, 128), bf, False, "sm90"),
             ("non-causal D=64", (2, 8, 2, 300, 200, 64, 64), bf, False, "sm90"),
             ("non-causal f32", (2, 8, 2, 300, 200, 64, 64), f32, False, "simt")]
    out = {"cases": [], "tolerance": {"float32": tol[f32], "bfloat16": tol[bf]}}
    for name, shape, dtype, causal, want_route in cases:
        q, k, v = qkv(*shape, dtype)
        before = fops.launches_by_route()
        got = flash_attention(q, k, v, causal=causal)
        took = [r for r, n in fops.launches_by_route().items() if n != before[r]]
        if fops.route(q, k, v) != want_route or took != [want_route]:
            raise AssertionError(f"flash_attention ({name}) took route {took}, want {want_route}")
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        err, share = check(name, got, want, dtype)
        row = {"name": name, "shape": list(shape), "dtype": str(dtype), "causal": causal,
               "route": want_route, "max_abs_err": err, "share_of_limit": share}
        if shape == path and dtype == bf:
            lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            row["library_max_abs_err"], row["library_share_of_limit"] = share_of(lib, want, bf)
            del lib
        out["cases"].append(row)
        log(f"  flash_attention {name} {tuple(shape)} causal={causal} route {want_route}: "
            f"max_abs_err {err:.3g}, {share:.3f} of the limit {tol[dtype]}")
        if "library_share_of_limit" in row:
            log(f"    scaled_dot_product_attention on the same inputs: max_abs_err "
                f"{row['library_max_abs_err']:.3g}, {row['library_share_of_limit']:.3f} of the "
                "limit (for information, not asserted)")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    q, k, v = qkv(*path, bf)
    chunked = chunked_attention_ref(q.float(), k.float(), v.float())
    err, share = check("vs chunked", flash_attention(q, k, v), chunked, bf)
    log(f"  flash_attention path shape bf16 vs chunked_attention_ref (float32): max_abs_err "
        f"{err:.3g}, {share:.3f} of the limit")
    del chunked
    bound, by, ops, nbytes = flash_bound_ms(q, k, v, True)
    o = torch.empty_like(q)
    scale = q.shape[3] ** -0.5

    def sm90():
        return flash_attention(q, k, v)

    def simt():      # the SIMT kernel on the same bf16 inputs, through its binding
        fkernel.flash_attention(q, k, v, o, scale, True)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    turns = {"sm90": [], "simt": [], "library": []}
    for name, fn, iters in (("sm90", sm90, 20), ("simt", simt, 5), ("library", library, 20),
                            ("library", library, 20), ("simt", simt, 5), ("sm90", sm90, 20)):
        turns[name].append(cuda_ms(fn, iters=iters))
    simt()
    torch.cuda.synchronize()
    err_simt, share_simt = check("SIMT kernel, bf16", o, attention_ref(
        q.float(), k.float(), v.float()), bf)
    r = {"shape": f"B=1 Hq=24 Hkv=8 S={PREFILL_SEQ} D=128 causal bf16", "turns_ms": turns,
         "ms": sum(turns["sm90"]) / 2, "simt_ms": sum(turns["simt"]) / 2,
         "library_ms": sum(turns["library"]) / 2,
         "order": "sm90, simt, library, library, simt, sm90",
         "plain_ms": cuda_ms(lambda: chunked_attention_ref(q, k, v), iters=3, warmup=1),
         "plain": "chunked_attention_ref (block_k=512), the CPU dispatch's version at this Skv",
         "library": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
         "simt_share_of_limit": share_simt,
         "bound_ms": bound, "bound_by": by, "flop": ops, "bytes": nbytes}
    del q, k, v, o
    qf, kf, vf = qkv(1, 24, 8, PREFILL_SEQ, PREFILL_SEQ, 128, 128, f32)
    bf_, byf, _, _ = flash_bound_ms(qf, kf, vf, True)
    r["f32"] = {"ms": cuda_ms(lambda: flash_attention(qf, kf, vf), iters=5),
                "bound_ms": bf_, "bound_by": byf, "route": "simt"}
    del qf, kf, vf
    torch.cuda.empty_cache()
    out["timing"] = r
    out["max_abs_err"] = max(c["max_abs_err"] for c in out["cases"])
    out["sass"] = sass_counts(build.lib_path("flash_attention_sm90"))
    log(f"  flash_attention {r['ms']:.4f} ms on the tensor cores at {r['shape']} "
        f"({', '.join(f'{t:.4f}' for t in turns['sm90'])}); SIMT kernel {r['simt_ms']:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in turns['simt'])}); library {r['library_ms']:.4f} ms "
        f"({', '.join(f'{t:.4f}' for t in turns['library'])}); plain chunked "
        f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms by {by}: {ops / 1e9:.1f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB; float32 {r['f32']['ms']:.3f} ms on the SIMT kernel (bound "
        f"{bf_:.3f} ms at the CUDA-core rate)")
    log(f"  flash_attention_sm90 SASS: {out['sass']}")
    return out


def profile_model(torch, fn, name: str, out_dir: Path, host_ops: bool = True) -> dict:
    """``fn()`` under torch.profiler: device busy time and idle share, the top
    device kernels, and the top host ops (``host_ops``; else only the CUDA
    runtime's calls, about half the events to record and read back).  Only
    ``family_cell``'s forward and decode profiles pass ``host_ops=False``:
    the xLSTM forward's launches make the host table its slowest part, while
    the earlier phases' host tables are the breakdowns PERF.md §5 reads."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    row = _device_summary(torch, prof, wall, top=6, table=out_dir / f"profile_{name}.txt")
    row["post_processing_s"] = time.perf_counter() - t0 - wall
    log(f"  profile {name}: wall {row['wall_ms']:.2f} ms under the profiler, device busy "
        f"{row['device_busy_ms']:.3f} ms, idle share {row['device_idle_share']:.4f} "
        f"(the profiler's post-processing {row['post_processing_s']:.2f} s)")
    for r in row["top"][:3]:
        log(f"    device {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")
    for r in row["host_top"][:3]:
        log(f"    host {r['cpu_ms']:.3f} ms x{r['count']} {r['name'][:70]} (inclusive)")
    return row


def model_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """Phi-4-mini at full width on the card through the port's entry points:
    the full-depth prefill forward (flash kernel), the serving engine
    (decode attention), and decode against forward (see the docstring)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build
    from repro_torch.serve import new_instance

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MODEL_ARCH)
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "param_count": cfg.param_count()}
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    # prefill: Model.forward, all layers, one 8,192-token sequence
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=device)
    params = model.init(seed)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_SEQ), generator=g, device=device)
    fwd_s = []
    for i in range(2):
        if i == 0:
            fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        if i == 0:
            rep["launches"] = flash_attention.launches
            rep["launches_by_route"] = fops.launches_by_route()
            if rep["launches_by_route"] != {"sm90": cfg.n_layers, "simt": 0}:
                raise AssertionError(f"prefill forward launched flash_attention "
                                     f"{rep['launches_by_route']}, want {cfg.n_layers} on the "
                                     "tensor-core route and none on the SIMT one")
        if (logits.shape != (1, PREFILL_SEQ, cfg.padded_vocab) or logits.dtype != torch.float32
                or not bool(torch.isfinite(logits[..., :cfg.vocab]).all())):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} {logits.dtype} not "
                                 "finite / of the expected shape")
        del logits
    rep["forward_s"] = fwd_s
    rep["forward_tokens_per_s"] = PREFILL_SEQ / min(fwd_s)
    rep["forward_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  prefill: Model.forward of {PREFILL_SEQ} tokens, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}: {fwd_s[0]:.3f} s cold, {fwd_s[1]:.3f} s warm; "
        f"flash_attention launches {rep['launches']} {rep['launches_by_route']}; logits finite; "
        "peak device memory "
        f"{rep['forward_peak_mem_bytes'] / 2**30:.3f} GiB (init {rep['init_s']:.2f} s)")
    rep["profile_prefill"] = profile_model(
        torch, lambda: model.forward(params, {"tokens": tokens}), "prefill", out_dir)

    # serve: 4 requests of 128-token prompts, 32 new tokens each, through generate
    batch, prompt_len, n_new = 4, 128, 32
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=device)
    before = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inst = new_instance(cfg, params, batch=batch, max_len=prompt_len + n_new, device=device)
    answer = inst.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if answer.shape != (batch, n_new) or inst.pos != prompt_len + n_new:
        raise AssertionError(f"generate gave {answer.shape} at pos {inst.pos}")
    if flash_attention.launches != before:
        raise AssertionError("the serving engine launched flash_attention")
    # the same requests once more, prefill and decode timed apart
    inst2 = new_instance(cfg, params, batch=batch, max_len=prompt_len + n_new, device=device)
    again, pre_logits, _last, prefill_s, decode_s = serve_timed(torch, np, inst2, prompts, n_new)
    if not np.array_equal(again, answer):
        raise AssertionError("a second serving of the same requests gave other tokens")
    rep["serve"] = {"batch": batch, "prompt_len": prompt_len, "new_tokens": n_new,
                    "generate_s": gen_s, "prefill_s": prefill_s, "decode_s": decode_s,
                    "decode_tokens_per_s": batch * n_new / decode_s,
                    "prefill_tokens_per_s": batch * prompt_len / prefill_s,
                    "answer_first_tokens": answer[:, :4].tolist()}
    log(f"  serve: {batch} requests x {prompt_len}-token prompts, {n_new} new tokens each: "
        f"generate {gen_s:.3f} s (incl. instance set-up); timed apart: prefill "
        f"{prefill_s:.3f} s ({rep['serve']['prefill_tokens_per_s']:.1f} tokens/s, one decode "
        f"step per prompt token), decode {decode_s:.3f} s "
        f"({rep['serve']['decode_tokens_per_s']:.1f} tokens/s); flash_attention launches "
        "unchanged; both servings gave the same tokens")
    del inst

    # decode vs forward, full depth bf16: last-position logits of the forward
    # (flash path) against the engine's prefill logits (decode path)
    full, _ = model.forward(params, {"tokens": prompts})
    last = full[:, -1]
    del full
    rel = float((last - pre_logits).abs().max() / last.abs().max())
    agree = float((last.argmax(-1) == pre_logits.argmax(-1)).float().mean())
    rep["bf16_forward_vs_prefill"] = {"rel_max_err": rel, "argmax_agreement": agree}
    log(f"  full depth bf16: forward last-position logits vs engine prefill logits: "
        f"relative max error {rel:.4g}, argmax agreement {agree:.2f} (not asserted)")
    del inst2, last, pre_logits, _last

    # four decode steps of a fresh instance under the profiler (after two)
    inst3 = new_instance(cfg, params, batch=batch, max_len=8, device=device)
    tok = prompts[:, :1].to(torch.int32)
    for _ in range(2):
        inst3.decode(tok)

    def four_steps():
        for _ in range(4):
            inst3.decode(tok)
    rep["profile_decode"] = profile_model(torch, four_steps, "decode", out_dir)
    del inst3, params, model
    torch.cuda.empty_cache()

    # decode vs forward, full width, 2 layers, float32 compute (tests/test_models.py's bound)
    cfg2 = dataclasses.replace(cfg, name=f"{cfg.name}-2l-f32", n_layers=2,
                               compute_dtype="float32")
    rel2 = decode_vs_forward(torch, cfg2, seed + 1, device, g)
    rep["f32_decode_vs_forward_rel"] = rel2
    log(f"  full width, 2 layers, float32: decode vs forward relative max error {rel2:.3g} "
        "(< 2e-3)")
    return rep


# ----------------------------------------------------------------------------
# train: the flash-attention backward, Phi-4-mini training, the quickstart twin
# ----------------------------------------------------------------------------

def flash_bwd_bound_ms(q, k, v, causal: bool):
    """Least time for one backward: 5 products per (query, key) pair the
    mask keeps, of 2*Dk operations (S, dQ, dK) or 2*Dv (dP, dV), at the peak
    rate for the inputs' type, against q, k, v, O, dO and lse read and dq,
    dk, dv written once at the memory rate."""
    import torch

    b, hq, sq, dk = q.shape
    skv, dv = k.shape[2], v.shape[3]
    ops = (6 * dk + 4 * dv) * flash_pairs(b, hq, sq, skv, causal)
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    # q read and dq written, O and dO read; k, v read and dk, dv written; lse read
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + b * hq * sq * dv) * q.element_size()
              + b * hq * sq * 4)
    t, by = bound_ms(nbytes, 0)
    if ops / rate * 1e3 > t:
        t, by = ops / rate * 1e3, "operations"
    return t, by, ops, nbytes


BWD_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (2.0 ** -6, 1e-4)}


def flash_bwd_cases(torch, g, cases, out: dict) -> None:
    """Each case of ``cases`` (name, (B, Hq, Hkv, Sq, Skv, Dk, Dv), dtype,
    causal, forward route, backward route, dO as a view whose rows no TMA
    map takes): the forward under autograd and the backward, each on its
    asserted route, against autograd through the float32 ``attention_ref``
    on the upcast inputs and against ``flash_attention_bwd_ref`` on the same
    saved output and log-sum-exp, within ``BWD_TOL`` per gradient; a second
    launch bit-equal.  Rows go to ``out["cases"]``."""
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention_bwd,
                                                     flash_attention_bwd_ref)
    from repro_torch.kernels.flash_attention import ops as fops

    device = g.device

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    def share(got, want, dtype):
        rtol, atol = BWD_TOL[str(dtype).split(".")[-1]]
        err = float((got.float() - want.float()).abs().max())
        return err, err / (rtol * float(want.float().abs().max()) + atol)

    def unaligned(t):
        """The same values in a view whose rows are 4 elements longer than D
        (264 bytes at D = 128 in bf16: no multiple of 16, so no TMA map)."""
        view = torch.empty(*t.shape[:3], t.shape[3] + 4, dtype=t.dtype, device=t.device)
        return view[..., :t.shape[3]].copy_(t)

    for name, shape, dtype, causal, want_route, want_bwd, view in cases:
        b, hq, hkv, sq, skv, dk, dv = shape
        q, k = randn(b, hq, sq, dk, dtype=dtype), randn(b, hkv, skv, dk, dtype=dtype)
        v, do = randn(b, hkv, skv, dv, dtype=dtype), randn(b, hq, sq, dv, dtype=dtype)
        if view:
            do = unaligned(do)
        scale = dk ** -0.5
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        before = fops.launches_by_route()
        o = fops.flash_attention(qg, kg, vg, causal=causal)
        took = [r for r, n in fops.launches_by_route().items() if n != before[r]]
        if took != [want_route]:
            raise AssertionError(f"flash backward ({name}): the forward took {took}, "
                                 f"want {want_route}")
        before = fops.launches_by_route(flash_attention_bwd)
        nb = flash_attention_bwd.launches
        got = torch.autograd.grad(o, (qg, kg, vg), do)
        took = [r for r, n in fops.launches_by_route(flash_attention_bwd).items()
                if n != before[r]]
        if flash_attention_bwd.launches != nb + 1 or took != [want_bwd]:
            raise AssertionError(f"flash backward ({name}): {flash_attention_bwd.launches - nb} "
                                 f"backward launches on {took}, want 1 on {want_bwd}")
        _, lse = fops._forward(q, k, v, causal, scale, with_lse=True)
        o_saved = o.detach()
        again = flash_attention_bwd(q, k, v, o_saved, lse, do, causal=causal)
        plain = flash_attention_bwd_ref(q, k, v, o_saved, lse, do, causal=causal, scale=scale)
        qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
        want = torch.autograd.grad(attention_ref(qf, kf, vf, causal=causal), (qf, kf, vf),
                                   do.float())
        torch.cuda.synchronize()
        row = {"name": name, "shape": list(shape), "dtype": str(dtype), "causal": causal,
               "route": want_route, "bwd_route": want_bwd, "grads": {}}
        for gname, a, b2, p, w in zip(("dq", "dk", "dv"), got, again, plain, want):
            if not torch.equal(a, b2):
                raise AssertionError(f"flash backward ({name}): two launches differ in {gname}")
            err, sh = share(a, w, dtype)
            perr, psh = share(a, p, dtype)
            if a.dtype != dtype or a.shape != w.shape or sh > 1 or psh > 1:
                raise AssertionError(f"flash backward ({name}) {gname}: max_abs_err {err} "
                                     f"({sh:.3f} of the limit) against autograd, {perr} "
                                     f"({psh:.3f}) against the plain backward")
            row["grads"][gname] = {"max_abs_err": err, "share_of_limit": sh,
                                   "vs_plain_max_abs_err": perr, "vs_plain_share": psh}
        row["max_abs_err"] = max(r["max_abs_err"] for r in row["grads"].values())
        out["cases"].append(row)
        log(f"  flash backward {name} {tuple(shape)} causal={causal} (forward on {want_route}, "
            f"backward on {want_bwd}): "
            + ", ".join(f"{k} {r['max_abs_err']:.3g} ({r['share_of_limit']:.3f} of the limit; "
                        f"plain {r['vs_plain_share']:.3f})" for k, r in row["grads"].items())
            + "; two launches bit-equal")
        if name == out.get("library_case"):
            # the library's bf16 backward on the same inputs, held to the same limit
            group = q.shape[1] // k.shape[1]
            ql = q.clone().requires_grad_(True)
            kl = k.repeat_interleave(group, 1).requires_grad_(True)
            vl = v.repeat_interleave(group, 1).requires_grad_(True)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = torch.autograd.grad(sdpa(ql, kl, vl, is_causal=True), (ql, kl, vl), do)
            lib = (lib[0], *(x.float().unflatten(1, (k.shape[1], group)).sum(2)
                             for x in lib[1:]))
            out["library_share_of_limit"] = {gname: share(x, w, dtype)[1]
                                             for gname, x, w in zip(("dq", "dk", "dv"), lib,
                                                                    want)}
            log(f"  library backward (scaled_dot_product_attention, {dtype}) at {name}: "
                + ", ".join(f"{k} {v:.3f}" for k, v in out["library_share_of_limit"].items())
                + " of the limit (dK, dV summed over each group in float32)")
            del ql, kl, vl, lib
        del q, k, v, do, qg, kg, vg, o, got, again, plain, want, qf, kf, vf, lse, o_saved
    torch.cuda.empty_cache()


def simt_bwd(torch, q, k, v, o, lse, do, causal: bool = True):
    """The SIMT backward kernel through its binding, whatever route the rule
    gives (uncounted: timing only)."""
    from repro_torch.kernels.flash_attention import kernel as fkernel

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fkernel.flash_attention_bwd(q, k, v, o, do, lse, delta, dq, dk, dv, q.shape[3] ** -0.5,
                                causal)
    return dq, dk, dv


def time_flash_bwd(torch, g, shape, simt: bool) -> dict:
    """At ``shape`` (B, Hq, Hkv, S, S, Dk, Dv), causal, on bf16 inputs from
    ``g``: in turns the tensor-core backward (its route asserted), the SIMT
    kernel on the same inputs (with ``simt``), the plain version and the
    library's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention``, K and V repeated to Hq), beside the
    bound and the work the tensor-core kernel issues.  Timing launches are
    not a path's: the counts are put back."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops as fops

    b, hq, hkv, s, _, dk, dv = shape
    device, bf = g.device, torch.bfloat16
    q = torch.randn(b, hq, s, dk, generator=g, device=device).to(bf)
    k = torch.randn(b, hkv, s, dk, generator=g, device=device).to(bf)
    v = torch.randn(b, hkv, s, dv, generator=g, device=device).to(bf)
    do = torch.randn(b, hq, s, dv, generator=g, device=device).to(bf)
    o, lse = fops._forward(q, k, v, True, dk ** -0.5, with_lse=True)
    if fops.bwd_route(q, k, v, do) != "sm90":
        raise AssertionError(f"flash backward: the timed inputs {shape} do not take the sm90 "
                             "route")
    ql = q.clone().requires_grad_(True)
    kl = k.repeat_interleave(hq // hkv, 1).requires_grad_(True)
    vl = v.repeat_interleave(hq // hkv, 1).requires_grad_(True)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    fns = {"sm90": lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
           "simt": lambda: simt_bwd(torch, q, k, v, o, lse, do),
           "plain": lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True),
           "library": lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)}
    order = tuple(n for n in ("sm90", "simt", "plain", "library", "library", "plain", "simt",
                              "sm90") if simt or n != "simt")
    iters = {"sm90": 10, "simt": 2, "plain": 2, "library": 10}
    nb = (flash_attention_bwd.launches, fops.launches_by_route(flash_attention_bwd))
    turns = {n: [] for n in order}
    for n in order:
        turns[n].append(cuda_ms(fns[n], iters=iters[n], warmup=1))
    flash_attention_bwd.launches = nb[0]
    for r, n in nb[1].items():
        setattr(flash_attention_bwd, f"launches_{r}", n)
    bound, by, ops, nbytes = flash_bwd_bound_ms(q, k, v, True)
    heads = f"Hq={hq} Hkv={hkv}" if hq != hkv else f"Hq=Hkv={hq}"
    width = f"D={dk}" if dk == dv else f"Dk={dk} Dv={dv}"
    r = {"shape": f"B={b} {heads} S={s} {width} causal bf16", "route": "sm90",
         "turns_ms": turns, "order": ", ".join(order),
         **{("ms" if n == "sm90" else f"{n}_ms"): sum(t) / 2 for n, t in turns.items()},
         "plain": "flash_attention_bwd_ref (block_k=512)",
         "library": "torch.autograd.grad through F.scaled_dot_product_attention("
                    "is_causal=True), K and V repeated to Hq, its backward alone",
         "bound_ms": bound, "bound_by": by, "flop": ops, "bytes": nbytes,
         # 7 products: S^T, dP^T, dV, dK, then S, dP again and dQ
         "issued_flop": (8 * dk + 6 * dv) * flash_pairs(b, hq, s, s, True)}
    simt_text = f"; simt {r['simt_ms']:.3f} ms" if simt else ""
    log(f"  flash backward at {r['shape']}: sm90 {r['ms']:.4f} ms "
        f"({', '.join(f'{t:.4f}' for t in turns['sm90'])}), "
        f"{r['ms'] / r['library_ms']:.2f}x the library{simt_text}; plain {r['plain_ms']:.3f} ms; "
        f"library backward {r['library_ms']:.4f} ms; bound {bound:.4f} ms by {by}: "
        f"{ops / 1e9:.1f} GFLOP ({r['issued_flop'] / 1e9:.1f} issued), {nbytes / 1e6:.1f} MB")
    del q, k, v, do, o, lse, ql, kl, vl, lib_out, fns
    torch.cuda.empty_cache()
    return r


def check_flash_bwd(torch, device, seed: int) -> dict:
    """The flash-attention backward on the card, on both of its routes
    (``ops.bwd_route``), case by case through ``flash_bwd_cases``: bf16 cases
    take the tensor-core kernel; float32, and bf16 with a dO view whose rows
    are not a multiple of 16 bytes, the SIMT kernel.  At the training shape
    the library's bf16 backward (``scaled_dot_product_attention`` with K and
    V repeated to Hq) is held to the same limit too, printed as a yardstick
    of what bf16 products give; then, in turns, the tensor-core kernel, the
    SIMT kernel on the same inputs, the plain version and the library's
    backward, beside the bound (``time_flash_bwd``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + 23)
    bf, f32 = torch.bfloat16, torch.float32

    path = (1, 24, 8, TRAIN_SEQ, TRAIN_SEQ, 128, 128)
    # name, shape, dtype, causal, forward route, backward route, dO as an unaligned view
    cases = [("training shape bf16", path, bf, True, "sm90", "sm90", False),
             ("training shape bf16, dO rows of 264 bytes", path, bf, True, "sm90", "simt", True),
             ("training shape f32", path, f32, True, "simt", "simt", False),
             ("D=64", (1, 24, 8, 2048, 2048, 64, 64), bf, True, "sm90", "sm90", False),
             ("S=1000, not a multiple of the tile", (1, 24, 8, 1000, 1000, 128, 128), bf, True,
              "sm90", "sm90", False),
             ("ragged Sq=700<Skv=1100", (1, 24, 8, 700, 1100, 128, 128), bf, True, "sm90",
              "sm90", False),
             ("non-causal", (1, 24, 8, 1000, 1000, 128, 128), bf, False, "sm90", "sm90", False),
             ("MHA", (1, 8, 8, 1024, 1024, 128, 128), bf, True, "sm90", "sm90", False)]
    out = {"cases": [], "tolerance": BWD_TOL, "library_case": "training shape bf16"}
    flash_bwd_cases(torch, g, cases, out)

    out["timing"] = time_flash_bwd(torch, g, path, simt=True)
    out["max_abs_err"] = {route: max(c["max_abs_err"] for c in out["cases"]
                                     if c["bwd_route"] == route) for route in ("sm90", "simt")}
    return out


def tree_fingerprint(torch, tree) -> list:
    """Per leaf, in tree order: dtype, shape and two int64 sums of its 32-bit
    words (plain and position-weighted, wrapping), computed on the card in
    chunks of 2^26 words (1.6 GB of temporaries at most): any changed word
    changes them but with odds of 2^-64."""
    from repro_torch.tree import tree_leaves

    chunk = 1 << 26
    fp = []
    for t in tree_leaves(tree):
        flat = t.detach().reshape(-1)
        flat = flat.view(torch.int32) if t.element_size() == 4 else flat.view(torch.uint8)
        plain = weighted = 0
        for start in range(0, flat.numel(), chunk):
            words = flat[start:start + chunk].to(torch.int64)
            pos = torch.arange(start, start + words.numel(), device=words.device,
                               dtype=torch.int64)
            plain += int(words.sum())
            weighted += int((words * (pos * 2654435761 + 1)).sum())
        fp.append((str(t.dtype), tuple(t.shape), plain, weighted % (1 << 64)))
    return fp


def train_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """Training on the card (see the module docstring): (a) the backward
    kernel's checks and timings; (b) Phi-4-mini at full width, cut in depth,
    6 uninterrupted steps, then 3 steps with a blocking checkpoint, a crash
    and a resume to step 6 through ``Trainer.run(resume=True)``; (c) the
    quickstart twin with asynchronous checkpoints."""
    import dataclasses
    import gc
    import threading

    from torch.profiler import ProfilerActivity, profile

    import quickstart
    from repro_torch.checkpoint.ckpt import flatten_state
    from repro_torch.configs.base import get_config
    from repro_torch.core import HierarchicalPool, Orchestrator, PoolMaster, RestoreEngine
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.snapshot_fuse import ops
    from repro_torch.models import build
    from repro_torch.train import LoopConfig, Trainer
    from repro_torch.train.trainstep import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = {"backward": check_flash_bwd(torch, device, seed)}
    counted = data_plane_wrappers()
    threads_before = set(threading.enumerate())
    t_phase = time.perf_counter()

    cfg = dataclasses.replace(get_config(MODEL_ARCH), n_layers=TRAIN_LAYERS,
                              name=f"{MODEL_ARCH}-train-{TRAIN_LAYERS}l")
    n_layers = cfg.n_layers
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=1,
                                      seed=0))
    model = build(cfg, device=device)
    rep["config"] = {"arch": MODEL_ARCH, "n_layers": n_layers, "d_model": cfg.d_model,
                     "vocab": cfg.vocab, "param_count": cfg.param_count(), "remat": cfg.remat,
                     "compute_dtype": cfg.compute_dtype, "seq": TRAIN_SEQ, "global_batch": 1,
                     "reduced": [f"depth 32 -> {n_layers}", "train_4k global batch 256 -> 1"]}
    log(f"  {cfg.name}: {cfg.param_count():,} float32 parameters at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}), remat {cfg.remat}, bf16 compute; cut: "
        + "; ".join(rep["config"]["reduced"]))

    def batch(i):
        return {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(i).items()}

    def reset():
        fops.reset_launches()
        for k in counted.values():
            k.launches = 0

    # (b1) six uninterrupted steps
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    step = make_train_step(model)
    state = init_train_state(model, seed)
    walls, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch(i))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    want_fwd, want_bwd = 2 * n_layers * TRAIN_STEPS, n_layers * TRAIN_STEPS
    got = {"flash_attention": flash_attention.launches, "by_route": fops.launches_by_route(),
           "flash_attention_bwd": flash_attention_bwd.launches,
           "bwd_by_route": fops.launches_by_route(flash_attention_bwd)}
    if got["by_route"] != {"sm90": want_fwd, "simt": 0} or \
            got["bwd_by_route"] != {"sm90": want_bwd, "simt": 0}:
        raise AssertionError(f"train: {TRAIN_STEPS} steps launched {got}, want {want_fwd} sm90 "
                             f"forwards (remat: twice a layer) and {want_bwd} sm90 backwards")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"train: losses {losses} grad norms {gnorms} not finite")
    rep["uninterrupted"] = {"losses": losses, "grad_norms": gnorms, "step_s": walls,
                            "tokens_per_s": TRAIN_SEQ / min(walls[1:]), "launches": got}
    peaks = {"uninterrupted": torch.cuda.max_memory_allocated()}
    log(f"  6 uninterrupted steps: losses {', '.join(f'{x:.4f}' for x in losses)}; grad norms "
        f"{', '.join(f'{x:.3f}' for x in gnorms)}; step walls "
        f"{', '.join(f'{x:.3f}' for x in walls)} s ({rep['uninterrupted']['tokens_per_s']:.0f} "
        f"tokens/s at the best warm step); launches {got}")

    # one more step (state is not kept) under the profiler: the backward's share
    probe = tree_map(torch.clone, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        probe, _ = step(probe, batch(TRAIN_STEPS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = _device_summary(torch, prof, wall, top=8,
                              table=out_dir / "profile_train_step.txt")
    by_name = {k: ms for k, (_n, ms) in profile_by_name(torch, prof)[0].items()}
    bwd_parts = {part: sum(t for n, t in by_name.items() if part in n)
                 for part in ("prep_kernel", "delta_kernel", "dkdv_kernel", "dq_kernel")}
    bwd_ms = sum(bwd_parts.values())
    fwd_ms = sum(t for n, t in by_name.items() if "flash_sm90_kernel" in n)
    summary.update(backward_ms=bwd_ms, backward_share=bwd_ms / summary["device_busy_ms"],
                   backward_ms_by_kernel=bwd_parts, forward_flash_ms=fwd_ms)
    rep["profile_step"] = summary
    del prof, probe
    reset()
    log(f"  profiled step: wall {wall:.3f} s, device busy {summary['device_busy_ms']:.1f} ms, "
        f"idle share {summary['device_idle_share']:.4f}; flash backward {bwd_ms:.2f} ms = "
        f"{summary['backward_share']:.4f} of the device time "
        f"({', '.join(f'{k} {v:.3f}' for k, v in bwd_parts.items() if v)}), flash forward "
        f"{fwd_ms:.1f} ms")
    for r in summary["top"][:5]:
        log(f"    {r['device_ms']:.3f} ms x{r['count']} {r['name'][:70]}")

    final_ref = tree_map(lambda t: t.cpu(), state.params)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    # (b2) a Trainer: 3 steps, a blocking checkpoint at step 3, then the crash
    n_params = cfg.param_count()
    slack = 256 << 20
    pool = HierarchicalPool(cxl_capacity=4 * n_params + slack,
                            rdma_capacity=8 * n_params + slack, device=device)
    free0 = (pool.cxl.free_list(), pool.rdma.free_list())
    master = PoolMaster(pool, publish_fn=ops.make_fused_publish_fn())
    name = f"{cfg.name}-ckpt"
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = Trainer(model, data, master=master,
                 loop_cfg=LoopConfig(steps=TRAIN_CKPT_STEP, ckpt_every=TRAIN_CKPT_STEP,
                                     ckpt_name=name, async_checkpoint=False, log_every=1),
                 seed=seed)
    state3 = t1.run()
    torch.cuda.synchronize()
    fp3 = tree_fingerprint(torch, state3)
    ck = t1.ckpt_stats[-1]
    n_publish = counted["fused_publish"].launches
    if [s["step"] for s in t1.ckpt_stats] != [TRAIN_CKPT_STEP] or n_publish != 1:
        raise AssertionError(f"train: checkpoints {t1.ckpt_stats}, fused_publish launches "
                             f"{n_publish}, want one at step {TRAIN_CKPT_STEP}")
    rep["checkpoint"] = {k: ck[k] for k in ("publish_s", "total_pages", "zero", "hot", "cold",
                                            "cxl_bytes", "rdma_bytes")}
    first_losses = [m["loss"] for m in t1.metrics_log if "loss" in m]
    peaks["trainer_and_blocking_checkpoint"] = torch.cuda.max_memory_allocated()
    log(f"  Trainer: {TRAIN_CKPT_STEP} steps (losses "
        f"{', '.join(f'{x:.4f}' for x in first_losses)}), blocking checkpoint at step "
        f"{TRAIN_CKPT_STEP}: {ck['total_pages']} pages (hot {ck['hot']}, cold {ck['cold']}, "
        f"zero {ck['zero']}) published in {ck['publish_s']:.3f} s wall; then the crash")
    if first_losses != losses[:TRAIN_CKPT_STEP]:
        raise AssertionError(f"train: the Trainer's losses {first_losses} differ from the "
                             f"uninterrupted run's {losses[:TRAIN_CKPT_STEP]}")
    del t1, state3
    gc.collect()
    torch.cuda.empty_cache()
    fwd_b2 = fops.launches_by_route()["sm90"]

    # (b3) a second Trainer resumes and trains to step 6
    torch.cuda.reset_peak_memory_stats()
    orch = Orchestrator("trainer-host", pool, master.catalog, prefetch_cold=True,
                        scatter_fn=ops.FusedScatter())
    t2 = Trainer(model, data, master=master, orch=orch,
                 loop_cfg=LoopConfig(steps=TRAIN_STEPS, ckpt_every=0, ckpt_name=name,
                                     log_every=1), seed=seed)
    restored_fp = []
    real_try = t2.try_restore

    def try_restore(template):
        got = real_try(template)
        restored_fp.append(tree_fingerprint(torch, got[0]))
        rep["restore"] = {k: got[2][k] for k in ("time_to_hot_s", "time_to_full_s", "flushes",
                                                 "walk_routes")}
        return got

    t2.try_restore = try_restore
    final = t2.run(resume=True)
    torch.cuda.synchronize()
    st = rep["restore"]
    verified = orch.scatter_fn.stats["pages_verified"]
    if restored_fp != [fp3]:
        raise AssertionError("train: the restored state differs from the checkpointed one")
    if verified != ck["hot"] + ck["cold"]:
        raise AssertionError(f"train: {verified} pages verified, want {ck['hot'] + ck['cold']}")
    check_routes("train restore", st["walk_routes"], walks=1)
    n_chunks = -(-ck["hot"] // RestoreEngine.HOT_CHUNK_PAGES)
    want = {"fused_publish": 1,
            "fused_restore": restore_launches(orch.scatter_fn.stats, n_chunks, 1, st["flushes"]),
            "zero_detect": 0, "page_checksum": 0, "page_gather": 0, "page_scatter": 0}
    launches = {n: k.launches for n, k in counted.items()}
    resumed_steps = TRAIN_STEPS - TRAIN_CKPT_STEP
    want_fwd = 2 * n_layers * TRAIN_STEPS            # 3 + 3 steps, remat: twice a layer
    want_bwd = n_layers * TRAIN_STEPS
    flash = {"by_route": fops.launches_by_route(),
             "bwd_by_route": fops.launches_by_route(flash_attention_bwd)}
    if launches != want or flash != {"by_route": {"sm90": want_fwd, "simt": 0},
                                     "bwd_by_route": {"sm90": want_bwd, "simt": 0}}:
        raise AssertionError(f"train: launches {launches} {flash}, want {want}, {want_fwd} sm90 "
                             f"forwards, {want_bwd} sm90 backwards")
    resumed_losses = [m["loss"] for m in t2.metrics_log if "loss" in m]
    if not np.isfinite(resumed_losses).all() or len(resumed_losses) != resumed_steps:
        raise AssertionError(f"train: resumed losses {resumed_losses}")
    peaks["restore_and_resume"] = torch.cuda.max_memory_allocated()

    # the resumed parameters against the uninterrupted run's
    diffs = []
    for (path, a), b in zip(flatten_state(final_ref).items(), tree_leaves(final.params)):
        b = b.cpu()
        if not torch.equal(a, b):
            rel = float((a - b).abs().max() / a.abs().max())
            diffs.append((path, rel))
            if not torch.allclose(b, a, rtol=1e-6, atol=1e-7):
                raise AssertionError(f"train: resumed {path} differs from the uninterrupted "
                                     f"run's beyond rtol 1e-6, atol 1e-7 (relative {rel})")
    rep["resumed_equals_uninterrupted"] = "bit for bit" if not diffs else {
        "within rtol 1e-6 atol 1e-7": diffs}
    rep["resumed_losses"] = resumed_losses
    rep["launches"] = {**launches, "flash_attention": want_fwd, "flash_attention_bwd": want_bwd,
                       "flash_attention_bwd_by_route": {"sm90": want_bwd, "simt": 0}}
    log(f"  resumed with Trainer.run(resume=True): time to hot {st['time_to_hot_s']:.3f} s, to "
        f"full {st['time_to_full_s']:.3f} s; restored state equal to the checkpointed one "
        f"(fingerprints of every leaf), {verified} pages verified; losses "
        f"{', '.join(f'{x:.4f}' for x in resumed_losses)} (uninterrupted "
        f"{', '.join(f'{x:.4f}' for x in losses[TRAIN_CKPT_STEP:])}); final parameters "
        f"{'bit-equal to' if not diffs else 'within rtol 1e-6 of'} the uninterrupted run's "
        f"{diffs if diffs else ''}; launches {rep['launches']}")
    del final, t2, final_ref
    orch.close()
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the quickstart twin, asynchronous checkpoints, on the card
    reset()
    t0 = time.perf_counter()
    qs = quickstart.run(device=device, master=PoolMaster(
        HierarchicalPool(64 << 20, 128 << 20, device=device),
        publish_fn=ops.make_fused_publish_fn()))
    q_losses = qs["losses"]
    if not q_losses[-1] < q_losses[0] - 0.1 or qs["tokens"].shape != (1, 12):
        raise AssertionError(f"train: quickstart losses {q_losses}, tokens {qs['tokens']}")
    rep["quickstart"] = {"losses": q_losses, "tokens": qs["tokens"][0].tolist(),
                         "wall_s": time.perf_counter() - t0,
                         "checkpoints": [s["step"] for s in qs["ckpt_stats"]],
                         "launches": {"flash_attention": flash_attention.launches,
                                      "flash_attention_bwd": flash_attention_bwd.launches,
                                      "by_route": fops.launches_by_route(),
                                      "bwd_by_route": fops.launches_by_route(flash_attention_bwd),
                                      **{n: k.launches for n, k in counted.items()}}}
    bwd_q = rep["quickstart"]["launches"]["bwd_by_route"]
    if bwd_q["simt"] == 0 or bwd_q["sm90"] != 0:
        raise AssertionError(f"train: the quickstart twin's backwards went {bwd_q}, want all on "
                             "simt (its heads are 32 wide)")
    del qs
    log(f"  quickstart twin: losses {', '.join(f'{x:.3f}' for x in q_losses)}; async "
        f"checkpoints at {rep['quickstart']['checkpoints']}; restored params bit-identical; "
        f"generated {rep['quickstart']['tokens']}; {rep['quickstart']['wall_s']:.2f} s; "
        f"launches {rep['quickstart']['launches']}")

    if not master.delete(name) or master.gc() != 0 or \
            (pool.cxl.free_list(), pool.rdma.free_list()) != free0:
        raise AssertionError("train: delete + gc did not return the pool to its start")
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"train: threads left after the phase: {left}")
    del pool, master
    gc.collect()
    torch.cuda.empty_cache()
    rep["peak_mem_bytes_by_part"] = peaks
    rep["peak_mem_bytes"] = max(peaks.values())
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"  peak device memory by part: "
        + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peaks.items())
        + "; no thread left, pool back to its start")
    return rep


# ----------------------------------------------------------------------------
# sharding: compressed_psum, the elastic-restore twin, one dry-run cell
# ----------------------------------------------------------------------------

SHARDING_ARCH = "xlstm-125m"          # unreduced: 12 blocks, d_model 768, vocab 50,304
SHARDING_SEQ, SHARDING_BATCH, SHARDING_STEPS = 64, 8, 5      # the example's non-quick data
DRYRUN_CELL = ("phi4-mini-3.8b", "decode_32k")


def sharding_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """(a) ``compressed_psum`` over every gradient leaf of xLSTM-125M at full
    width on a one-rank NCCL group, each result bit-equal to
    ``dequantize_int8(*quantize_int8(g))``; (b) the elastic-restore twin
    (``scripts/elastic_restore.py``) on the same model at the example's
    non-quick data shape: train, publish through the fused publish, restore
    through the fused restore, ``reshard`` onto a (1, 1) ``cuda`` mesh, train
    on; the re-sharded parameters bit-equal to the checkpointed ones on the
    card, every page verified, every loss finite, launches exact; (c) one
    dry-run cell in a subprocess (its 256-rank fake group stays out of this
    process), its status ``ok``."""
    import gc

    import elastic_restore
    from repro_torch.configs.base import get_config
    from repro_torch.core import HierarchicalPool, PoolMaster, RestoreEngine
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.snapshot_fuse import ops
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.pools import pool_capacities
    from repro_torch.models.model_zoo import build
    from repro_torch.sharding.collectives import (compressed_psum, dequantize_int8,
                                                  quantize_int8)
    from repro_torch.train.trainstep import make_loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(SHARDING_ARCH)
    rep = {"arch": cfg.name, "params": cfg.param_count()}
    # (c) starts first: the dry run traces on the host while (a) and (b) use the card
    arch, shape = DRYRUN_CELL
    dry_path = ROOT / "experiments" / "torch" / "dryrun" / f"{arch}__{shape}__pod.json"
    dry_path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t_dry = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=ROOT)

    try:
        # (a) the compressed all-reduce over one step's gradients
        model = build(cfg, device=device)
        params = model.init(seed)
        data = SyntheticLMData(DataConfig(vocab=cfg.vocab, seq_len=SHARDING_SEQ,
                                          global_batch=SHARDING_BATCH))
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch_at(0).items()}
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = make_loss_fn(model)(leaves, batch)
        loss.backward()
        grads = [p.grad for p in tree_leaves(leaves)]
        del leaves, loss
        with host_mesh(1, 1, device="cuda") as mesh:
            import torch.distributed as dist

            backend = dist.get_backend()
            compressed_psum(grads[0][:1])         # the communicator's lazy start, untimed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [compressed_psum(g) for g in grads]
            torch.cuda.synchronize()
            psum_s = time.perf_counter() - t0
            for i, (g, out) in enumerate(zip(grads, outs)):
                want = dequantize_int8(*quantize_int8(g))
                if out.device != g.device or not torch.equal(out, want):
                    raise AssertionError(f"sharding: compressed_psum of gradient leaf {i} "
                                         f"{tuple(g.shape)} differs from quantize + dequantize")
        if dist.is_initialized():
            raise AssertionError("sharding: host_mesh left its process group behind")
        n_elems = sum(g.numel() for g in grads)
        rep["compressed_psum"] = {"leaves": len(grads), "elements": n_elems, "backend": backend,
                                  "mesh": list(mesh.shape), "wall_s": psum_s}
        log(f"  compressed_psum: {len(grads)} gradient leaves of {cfg.name} ({n_elems:,} "
            f"elements) on a one-rank {backend} group, each bit-equal to quantize + dequantize; "
            f"{psum_s * 1e3:.1f} ms wall")
        del model, params, grads, outs, batch
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the elastic-restore twin at full width
        counted = data_plane_wrappers()
        for k in counted.values():
            k.launches = 0
        fops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        master = PoolMaster(HierarchicalPool(*pool_capacities(cfg, moments=True), device=device),
                            publish_fn=ops.make_fused_publish_fn())
        scatter = ops.FusedScatter()
        t0 = time.perf_counter()
        # the cold tail ridden by the orchestrator's prefetcher: the example's
        # defaults demand-page it one page a fault (151,614 faults, 449 s to
        # full on an NVIDIA H100 80GB HBM3 at 700.00 W)
        er = elastic_restore.run(cfg, SHARDING_SEQ, SHARDING_BATCH, SHARDING_STEPS, device=device,
                                 master=master, scatter_fn=scatter, prefetch_cold=True)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {n: k.launches for n, k in counted.items()}
        sv, st = er["save_stats"], er["restore_stats"]
        losses = er["losses1"] + er["losses2"]
        if not np.isfinite(losses).all() or len(losses) != 2 * SHARDING_STEPS:
            raise AssertionError(f"sharding: elastic losses {losses}")
        if not er["reshard_bit_equal"]:
            raise AssertionError("sharding: the re-sharded parameters differ from the checkpointed")
        locals_ = [p.to_local() for p in tree_leaves(er["placed"])]
        if any(t.device != torch.device("cuda", 0) for t in locals_):
            raise AssertionError("sharding: a re-sharded parameter is not on cuda:0")
        verified = scatter.stats["pages_verified"]
        if verified != sv["hot"] + sv["cold"]:
            raise AssertionError(f"sharding: {verified} pages verified, want "
                                 f"{sv['hot'] + sv['cold']}")
        n_chunks = -(-sv["hot"] // RestoreEngine.HOT_CHUNK_PAGES)
        want = {"fused_publish": 1,
                "fused_restore": restore_launches(scatter.stats, n_chunks, 1, st["flushes"]),
                "zero_detect": 0, "page_checksum": 0, "page_gather": 0, "page_scatter": 0}
        flash = {"flash_attention": flash_attention.launches,
                 "flash_attention_bwd": flash_attention_bwd.launches}
        if launches != want or flash != {"flash_attention": 0, "flash_attention_bwd": 0}:
            raise AssertionError(f"sharding: launches {launches} {flash}, want {want} and no "
                                 "attention (xLSTM has none)")
        rep["elastic"] = {
            "seq": SHARDING_SEQ, "batch": SHARDING_BATCH, "steps": SHARDING_STEPS,
            "losses1": er["losses1"], "losses2": er["losses2"],
            "phase1_s": er["walls"]["phase1_s"], "phase2_s": er["walls"]["phase2_s"],
            "publish_s": er["walls"]["publish_s"],
            "time_to_hot_s": st["time_to_hot_s"], "time_to_full_s": st["time_to_full_s"],
            "pages": {k: sv[k] for k in ("total_pages", "zero", "hot", "cold")},
            "pages_verified": verified, "walk_routes": st["walk_routes"],
            "flushes": st["flushes"], "peak_mem_bytes": peak, "wall_s": twin_s,
            "launches": launches}
        e = rep["elastic"]
        log(f"  elastic twin: {cfg.name} full width, seq {SHARDING_SEQ}, batch {SHARDING_BATCH}, "
            f"{SHARDING_STEPS} + {SHARDING_STEPS} steps; phase 1 {e['phase1_s']:.3f} s (losses "
            f"{', '.join(f'{x:.4f}' for x in e['losses1'])}), publish {e['publish_s']:.3f} s "
            f"({sv['total_pages']} pages: hot {sv['hot']}, cold {sv['cold']}, zero {sv['zero']}), "
            f"time to hot {e['time_to_hot_s']:.3f} s, to full {e['time_to_full_s']:.3f} s, "
            f"{verified} pages verified, re-sharded onto a (1, 1) cuda mesh bit-equal to the "
            f"checkpointed parameters; phase 2 {e['phase2_s']:.3f} s (losses "
            f"{', '.join(f'{x:.4f}' for x in e['losses2'])}); peak {peak / 2**30:.3f} GiB; "
            f"launches {launches}")
        del er, master, scatter, locals_
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        dry.kill()
        dry.communicate()
        raise

    # (c) the dry-run cell, started with the phase in a process of its own
    try:
        stdout, stderr = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    dry_s = time.perf_counter() - t_dry
    if not dry_path.exists():
        raise AssertionError(f"sharding: the dry run exited {dry.returncode}, no record: "
                             f"{stdout[-1500:]} {stderr[-1500:]}")
    cell = json.loads(dry_path.read_text())
    (out_dir / dry_path.name).write_text(json.dumps(cell, indent=1))
    if dry.returncode != 0 or cell["status"] != "ok" or cell["chips"] != 256:
        raise AssertionError(f"sharding: dry-run cell {cell.get('status')} (exit "
                             f"{dry.returncode}): {cell.get('error')}\n"
                             f"{cell.get('traceback', '')[-1500:]}")
    terms = cell["roofline"]
    rep["dryrun"] = {"cell": f"{arch} x {shape} x 16x16", "wall_s": dry_s,
                     "lower_s": cell["lower_s"], "memory": cell["memory"],
                     "flops_per_device": terms["flops_per_device"],
                     "bytes_per_device": terms["bytes_per_device"],
                     "collective_bytes_per_device": terms["collective_bytes_per_device"],
                     "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
                     "collective_s": terms["collective_s"], "dominant": terms["dominant"],
                     "torch": torch.__version__}
    d = rep["dryrun"]
    log(f"  dry run {d['cell']} (a subprocess beside (a) and (b), 256 fake ranks, torch "
        f"{torch.__version__}): status ok, traced in {d['lower_s']} s ({dry_s:.1f} s wall); "
        f"per device "
        f"{d['flops_per_device']:.4g} flop, {d['bytes_per_device']:.4g} B, "
        f"{d['collective_bytes_per_device']:.4g} collective B; terms compute "
        f"{d['compute_s']:.4g} s, memory {d['memory_s']:.4g} s, collective "
        f"{d['collective_s']:.4g} s, dominant {d['dominant']}")
    rep["phase_wall_s"] = time.perf_counter() - t_phase
    return rep


# ----------------------------------------------------------------------------
# moe: OLMoE-1B-7B and DeepSeek-V3 (MLA, MoE, MTP) at full width
# ----------------------------------------------------------------------------

def check_flash_shapes(torch, device, seed: int, shapes, simt_timed=()) -> dict:
    """The flash forward at full-width prefill shapes, each on its asserted
    route, against its float32 plain version on the upcast inputs (the model
    phase's limits: bf16 within one rounding, 2^-8|want| + 1e-4); then the
    kernel and ``scaled_dot_product_attention`` on the same inputs timed in
    turns (for the names in ``simt_timed`` the SIMT kernel too, through its
    binding, uncounted), beside the plain version and the bound.
    ``shapes``: name -> ((B, Hq, Hkv, Sq, Skv, Dk, Dv), causal, route); bf16
    inputs from ``seed``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import chunked_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bf = torch.bfloat16
    rtol, atol = 2.0 ** -8, 1e-4
    out = {"tolerance": {"bfloat16": {"rtol": rtol, "atol": atol}}, "shapes": {}}

    def share_of(got, want):
        err = (got.float() - want).abs()
        return float(err.max()), float((err / (atol + rtol * want.abs())).max())

    # the float32 plain version is the chunked one (attention_ref's (128, 4096, 4096)
    # float32 score matrices at MLA's shape would take ~34 GB)
    for name, ((b, hq, hkv, sq, skv, dk, dv), causal, want_route) in shapes.items():
        q = torch.randn(b, hq, sq, dk, generator=g, device=device).to(bf)
        k = torch.randn(b, hkv, skv, dk, generator=g, device=device).to(bf)
        v = torch.randn(b, hkv, skv, dv, generator=g, device=device).to(bf)
        before = fops.launches_by_route()
        got = flash_attention(q, k, v, causal=causal)
        took = [r for r, n in fops.launches_by_route().items() if n != before[r]]
        if fops.route(q, k, v) != want_route or took != [want_route]:
            raise AssertionError(f"flash_attention ({name}) took route {took}, want {want_route}")
        want = chunked_attention_ref(q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        max_err, share = share_of(got, want)
        if got.dtype != bf or got.shape != want.shape or share > 1:
            raise AssertionError(f"flash_attention ({name}) differs from its float32 plain "
                                 f"version: max_abs_err {max_err}, {share:.3f} of the limit")
        del got, want

        def kernel():
            return flash_attention(q, k, v, causal=causal)

        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=hq != hkv)

        def simt():     # through its binding, allocating its output as the wrapper does
            o = torch.empty(b, hq, sq, dv, dtype=bf, device=device)
            fkernel.flash_attention(q, k, v, o, dk ** -0.5, causal)

        fns = {"simt": simt, "library": library, want_route: kernel}
        n_iter = 20 if want_route == "sm90" else 5
        iters = {"simt": 5, "library": n_iter, want_route: n_iter}
        counts = (flash_attention.launches, fops.launches_by_route())
        order = (want_route, "library", "library", want_route)
        if name in simt_timed and want_route != "simt":
            order = (want_route, "simt", "library", "library", "simt", want_route)
        turns = {n: [] for n in order}
        for n in order:
            turns[n].append(cuda_ms(fns[n], iters=iters[n]))
        flash_attention.launches = counts[0]           # timing launches are not a path's
        for r, n in counts[1].items():
            setattr(flash_attention, f"launches_{r}", n)
        bound, by, ops, nbytes = flash_bound_ms(q, k, v, causal)
        mask = "causal" if causal else "non-causal"
        seq = f"S={sq}" if sq == skv else f"Sq={sq} Skv={skv}"
        row = {"shape": f"B={b} Hq={hq} Hkv={hkv} {seq} Dk={dk} Dv={dv} {mask} bf16",
               "route": want_route, "max_abs_err": max_err, "share_of_limit": share,
               "turns_ms": turns, "order": ", ".join(order),
               "ms": sum(turns[want_route]) / 2, "library_ms": sum(turns["library"]) / 2,
               "library": f"F.scaled_dot_product_attention(is_causal={causal}"
                          + (", enable_gqa=True)" if hq != hkv else ")"),
               "plain_ms": cuda_ms(lambda: chunked_attention_ref(q, k, v, causal=causal),
                                   iters=2, warmup=1),
               "plain": "chunked_attention_ref (block_k=512)",
               "bound_ms": bound, "bound_by": by, "flop": ops, "bytes": nbytes}
        if want_route == "sm90":   # the split P: P_hi V and P_lo V
            row["issued_flop"] = ops // (2 * (dk + dv)) * (2 * dk + 4 * dv)
        simt_text = ""
        if "simt" in turns and want_route != "simt":
            row["simt_ms"] = sum(turns["simt"]) / 2
            simt_text = (f"; SIMT kernel {row['simt_ms']:.4f} ms "
                         f"({', '.join(f'{t:.4f}' for t in turns['simt'])})")
        out["shapes"][name] = row
        log(f"  flash_attention {name} {row['shape']} route {want_route}: {share:.3f} of the "
            f"limit; {row['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in turns[want_route])})"
            f"{simt_text}; library {row['library_ms']:.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in turns['library'])}), kernel / library "
            f"{row['ms'] / row['library_ms']:.2f}; plain chunked {row['plain_ms']:.3f} ms; "
            f"bound {bound:.4f} ms by {by}: {ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB")
        del q, k, v
        torch.cuda.empty_cache()
    return out


def check_flash_moe(torch, device, seed: int) -> dict:
    """The flash forward at the MoE family's two full-width prefill shapes,
    both on the tensor-core route, through ``check_flash_shapes`` (the SIMT
    kernel's time at MLA's shape is recorded in PERF.md §6); the
    registers, spills and SASS of the tensor-core library's kernels."""
    out = check_flash_shapes(torch, device, seed + 41, {
        "olmoe": ((1, 16, 16, MOE_SEQ, MOE_SEQ, 128, 128), True, "sm90"),
        "mla": ((1, 128, 128, MOE_SEQ, MOE_SEQ, 192, 128), True, "sm90")})
    out["resources"] = tensor_cores_no_spill(
        "flash_attention_sm90", tuple(f"flash_sm90_kernel{p}" for p in SM90_PAIRS),
        new=(f"flash_sm90_kernel{SM90_MLA}",))
    return out


def check_flash_bwd_mla(torch, device, seed: int) -> dict:
    """The backward with Dk != Dv through ``flash_bwd_cases``: bf16 at MLA's
    Dk = 192, Dv = 128 on the tensor cores (the MLA shape at S =
    ``MLA_BWD_SEQ``, non-causal, GQA with ragged Sq < Skv; a dO view no TMA
    map takes on SIMT), float32 and Dk = 64 < Dv = 128 on the SIMT kernel;
    two launches bit-equal.  Then at the MLA shape in bf16, in turns, the
    tensor-core kernel, the plain version and the library's backward, beside
    the bound (``time_flash_bwd``; the SIMT kernel's time there is recorded
    in PERF.md §6); the registers, spills and SASS of the tensor-core
    library's kernels."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + 43)
    bf, f32 = torch.bfloat16, torch.float32
    mla = (1, 128, 128, MLA_BWD_SEQ, MLA_BWD_SEQ, 192, 128)
    gqa = (1, 8, 2, 100, 333, 192, 128)
    cases = [("MLA shape bf16", mla, bf, True, "sm90", "sm90", False),
             ("MLA shape f32", mla, f32, True, "simt", "simt", False),
             ("Dk=192 Dv=128 non-causal", (2, 4, 4, 150, 300, 192, 128), bf, False, "sm90",
              "sm90", False),
             ("Dk=192 Dv=128 non-causal f32", (1, 4, 4, 96, 96, 192, 128), f32, False, "simt",
              "simt", False),
             ("Dk=192 Dv=128 GQA ragged Sq=100<Skv=333", gqa, bf, True, "sm90", "sm90", False),
             ("Dk=192 Dv=128 GQA ragged Sq=100<Skv=333 f32", gqa, f32, True, "simt", "simt",
              False),
             ("Dk=192 Dv=128, dO rows of 264 bytes", (1, 8, 8, 256, 256, 192, 128), bf, True,
              "sm90", "simt", True),
             ("Dk=64 < Dv=128", (1, 4, 2, 130, 130, 64, 128), f32, True, "simt", "simt", False),
             ("Dk=64 < Dv=128 bf16", (1, 4, 2, 130, 130, 64, 128), bf, True, "simt", "simt",
              False)]
    out = {"cases": [], "tolerance": BWD_TOL}
    flash_bwd_cases(torch, g, cases, out)
    out["timing"] = time_flash_bwd(torch, g, mla, simt=False)
    out["max_abs_err"] = {route: max(c["max_abs_err"] for c in out["cases"]
                                     if c["bwd_route"] == route) for route in ("sm90", "simt")}
    out["resources"] = tensor_cores_no_spill(
        "flash_attention_bwd_sm90",
        tuple(f"{kern}_kernel{p}" for kern in ("dkdv", "dq") for p in SM90_PAIRS),
        new=(f"dkdv_kernel{SM90_MLA}", f"dq_kernel{SM90_MLA}"))
    return out


def check_flash_bwd_d80(torch, device, seed: int) -> dict:
    """The backward at Zamba2's (Dk, Dv) = (80, 80) through
    ``flash_bwd_cases``: bf16 on the tensor cores (Zamba2's shape, GQA with
    ragged Sq < Skv past a 128-row tile, non-causal), a dO view no TMA map
    takes and float32 on the SIMT kernel; two launches bit-equal.  Then at
    Zamba2's shape ``time_flash_bwd`` with the SIMT kernel in the turns;
    the registers, spills and SASS of both tensor-core libraries' (80, 80)
    kernels (no spill, HGMMA > 0)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + 47)
    bf, f32 = torch.bfloat16, torch.float32
    zamba = FAMILY_FLASH_SHAPES["zamba2"][0]
    gqa = (1, 8, 2, 200, 333, 80, 80)
    cases = [("Zamba2 shape bf16", zamba, bf, True, "sm90", "sm90", False),
             ("D=80 GQA ragged Sq=200<Skv=333", gqa, bf, True, "sm90", "sm90", False),
             ("D=80 non-causal", (2, 4, 4, 150, 300, 80, 80), bf, False, "sm90", "sm90", False),
             ("D=80, dO rows of 168 bytes", (1, 8, 8, 256, 256, 80, 80), bf, True, "sm90",
              "simt", True),
             ("D=80 GQA ragged Sq=200<Skv=333 f32", gqa, f32, True, "simt", "simt", False)]
    out = {"cases": [], "tolerance": BWD_TOL}
    flash_bwd_cases(torch, g, cases, out)
    out["timing"] = time_flash_bwd(torch, g, zamba, simt=True)
    out["max_abs_err"] = {route: max(c["max_abs_err"] for c in out["cases"]
                                     if c["bwd_route"] == route) for route in ("sm90", "simt")}
    out["resources"] = {lib: tensor_cores_no_spill(lib, fns, new=fns) for lib, fns in (
        ("flash_attention_sm90", (f"flash_sm90_kernel{SM90_D80}",)),
        ("flash_attention_bwd_sm90", (f"dkdv_kernel{SM90_D80}", f"dq_kernel{SM90_D80}")))}
    return out


def decode_vs_forward(torch, cfg, seed: int, device, g, seq: int = 16) -> float:
    """Relative max error of ``seq`` decode steps against the forward's
    logits, 2 sequences, on ``cfg`` (float32 compute): tests/test_models.py's
    parity.  A VLM's vision embeds are its token embeddings (the modality
    difference removed, the M-RoPE positions kept; ``seq`` must pass the
    prefix); an encoder-decoder decodes from the cross K/V of its encoded
    seeded frames."""
    from repro_torch.models import build, encdec
    from repro_torch.models.common import embed

    model = build(cfg, device=device)
    params = model.init(seed)
    toks = torch.randint(0, cfg.vocab, (2, seq), generator=g, device=device)
    batch, enc_out = {"tokens": toks}, None
    if cfg.family == "vlm":
        batch["vision_embeds"] = embed(params["embed"], toks[:, :cfg.vision_prefix], torch.float32)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, seq, cfg.d_model, generator=g, device=device)
        enc_out = encdec.encode(params, batch["frames"], cfg)
    full, _ = model.forward(params, batch)
    caches = model.init_caches(params, 2, seq, enc_out=enc_out)
    dec = []
    for t in range(seq):
        lg, caches = model.decode_step(params, {"tokens": toks[:, t:t + 1], "pos": t}, caches)
        dec.append(lg[:, 0])
    # over the real vocabulary: the padded logits are -1e30 in both
    v = cfg.vocab
    rel = float((torch.stack(dec, 1)[..., :v] - full[..., :v]).abs().max()
                / full[..., :v].abs().max())
    del params, model, full, dec, caches, batch, enc_out
    torch.cuda.empty_cache()
    if not rel < 2e-3:
        raise AssertionError(f"{cfg.name}: float32 decode vs forward relative error {rel} >= 2e-3")
    return rel


def _want_flash(where: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{where}: flash_attention launched {got}, want {want}")


def olmoe_cell(torch, np, seed: int, device, out_dir: Path) -> dict:
    """Cell (10): OLMoE-1B-7B at full width and depth from seeded random
    weights: one ``MOE_SEQ``-token ``Model.forward`` (16 flash launches, all
    on the tensor-core route), ``MOE_SERVE`` requests through
    ``ServerInstance.generate`` at the reference's capacity factor, prefill
    and decode timed apart, a profiled forward and four decode steps; then
    float32 decode against forward on 2 layers at the no-drop capacity."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build
    from repro_torch.serve import new_instance

    cfg = get_config("olmoe-1b-7b")
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_experts": cfg.n_experts, "top_k": cfg.top_k, "param_count": cfg.param_count(),
           "capacity_factor": cfg.capacity_factor, "reduced": []}
    g = torch.Generator(device=device)
    g.manual_seed(seed + 47)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=device)
    params = model.init(seed)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, MOE_SEQ), generator=g, device=device)
    fwd_s = []
    for i in range(2):
        fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        if i == 0:
            rep["launches_by_route"] = fops.launches_by_route()
            _want_flash("OLMoE forward", rep["launches_by_route"],
                        {"sm90": cfg.n_layers, "simt": 0})
        if (logits.shape != (1, MOE_SEQ, cfg.padded_vocab) or logits.dtype != torch.float32
                or not bool(torch.isfinite(logits[..., :cfg.vocab]).all())
                or not bool(torch.isfinite(aux)) or float(aux) <= 0):
            raise AssertionError(f"OLMoE forward: logits {tuple(logits.shape)} {logits.dtype}, "
                                 f"aux {float(aux)}: not finite / of the expected shape")
        rep["aux"] = float(aux)
        del logits
    rep["forward_s"] = fwd_s
    rep["forward_tokens_per_s"] = MOE_SEQ / min(fwd_s)
    rep["forward_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  OLMoE-1B-7B: {cfg.param_count():,} float32 parameters, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} (init "
        f"{rep['init_s']:.2f} s); Model.forward of {MOE_SEQ} tokens: {fwd_s[0]:.3f} s cold, "
        f"{fwd_s[1]:.3f} s warm ({rep['forward_tokens_per_s']:.0f} tokens/s); flash_attention "
        f"{rep['launches_by_route']}; aux {rep['aux']:.4f}; logits finite; peak device memory "
        f"{rep['forward_peak_mem_bytes'] / 2**30:.3f} GiB")
    rep["profile_prefill"] = profile_model(
        torch, lambda: model.forward(params, {"tokens": tokens}), "olmoe_prefill", out_dir)

    batch, prompt_len, n_new = MOE_SERVE
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=device)
    fops.reset_launches()
    inst = new_instance(cfg, params, batch=batch, max_len=prompt_len + n_new, device=device)
    prefill, walls = inst.prefill, {}

    def timed_prefill(tokens):          # generate's own prefill, its wall taken apart
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(tokens)
        torch.cuda.synchronize()
        walls["prefill_s"] = time.perf_counter() - t0
        return out

    inst.prefill = timed_prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answer = inst.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if answer.shape != (batch, n_new) or inst.pos != prompt_len + n_new:
        raise AssertionError(f"OLMoE generate gave {answer.shape} at pos {inst.pos}")
    _want_flash("OLMoE serving", fops.launches_by_route(), {"sm90": 0, "simt": 0})
    # the wrapper and the instance refer to each other: a cycle that would keep the
    # instance's 12.9 GiB bf16 parameters alive until the cyclic collector runs
    del inst.prefill, prefill
    prefill_s = walls["prefill_s"]
    decode_s = gen_s - prefill_s
    rep["serve"] = {"batch": batch, "prompt_len": prompt_len, "new_tokens": n_new,
                    "generate_s": gen_s, "prefill_s": prefill_s, "decode_s": decode_s,
                    "decode_tokens_per_s": batch * n_new / decode_s,
                    "prefill_tokens_per_s": batch * prompt_len / prefill_s,
                    "answer_first_tokens": answer[:, :4].tolist()}
    log(f"  OLMoE serve: {batch} requests x {prompt_len}-token prompts, {n_new} new tokens "
        f"each at capacity factor {cfg.capacity_factor} through generate: {gen_s:.3f} s; its "
        f"prefill {prefill_s:.3f} s ({rep['serve']['prefill_tokens_per_s']:.1f} tokens/s, one "
        f"decode step a prompt token), its decode {decode_s:.3f} s "
        f"({rep['serve']['decode_tokens_per_s']:.1f} tokens/s); no flash launch; first tokens "
        f"{answer[:, :4].tolist()}")
    del inst
    inst = new_instance(cfg, params, batch=batch, max_len=8, device=device)
    tok = prompts[:, :1].to(torch.int32)
    for _ in range(2):
        inst.decode(tok)

    def four_steps():
        for _ in range(4):
            inst.decode(tok)
    rep["profile_decode"] = profile_model(torch, four_steps, "olmoe_decode", out_dir)
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del inst, params, model
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, name=f"{cfg.name}-2l-f32", n_layers=2,
                               compute_dtype="float32",
                               capacity_factor=float(cfg.n_experts) / cfg.top_k)
    fops.reset_launches()
    rep["f32_decode_vs_forward_rel"] = decode_vs_forward(torch, cfg2, seed + 1, device, g)
    _want_flash("OLMoE float32 parity", fops.launches_by_route(), {"sm90": 0, "simt": 2})
    log(f"  OLMoE full width, 2 layers ({cfg2.param_count():,} parameters), float32, "
        f"capacity factor {cfg2.capacity_factor}: decode vs forward relative max error "
        f"{rep['f32_decode_vs_forward_rel']:.3g} (< 2e-3)")
    return rep


def deepseek_cell(torch, np, seed: int, device, out_dir: Path) -> dict:
    """Cell (11): DeepSeek-V3 at full width on two layers (one dense, one
    MoE) with its MTP head: float32 decode against forward at the no-drop
    capacity first (the float32 model freed before the next), then the bf16
    model (``param_dtype`` cut to bf16): one ``MOE_SEQ``-token
    ``lm_forward_mtp`` (3 flash launches on the sm90 route: the trunk's two
    layers and the MTP block) and ``MLA_SERVE`` requests through the engine
    with ``mla_absorb`` off and on (tokens printed, not asserted)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build
    from repro_torch.models.transformer import lm_forward_mtp
    from repro_torch.serve import new_instance

    full = get_config("deepseek-v3-671b")
    reduced = [f"depth {full.n_layers} -> {DSV3_CUT['n_layers']} "
               f"(dense layers {full.n_dense_layers} -> {DSV3_CUT['n_dense_layers']})",
               "param_dtype float32 -> bfloat16 (one MoE layer is 11.3 B parameters)"]
    cfg = dataclasses.replace(full, name=f"{full.name}-2l", **DSV3_CUT)
    rep = {"arch": full.name, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_experts": cfg.n_experts, "top_k": cfg.top_k, "n_layers": cfg.n_layers,
           "n_dense_layers": cfg.n_dense_layers, "param_count": cfg.param_count(),
           "reduced": reduced}
    g = torch.Generator(device=device)
    g.manual_seed(seed + 53)

    cfg32 = dataclasses.replace(cfg, name=f"{cfg.name}-f32", param_dtype="float32",
                                compute_dtype="float32",
                                capacity_factor=float(cfg.n_experts) / cfg.top_k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fops.reset_launches()
    t0 = time.perf_counter()
    rep["f32_decode_vs_forward_rel"] = decode_vs_forward(torch, cfg32, seed + 1, device, g)
    _want_flash("DeepSeek-V3 float32 parity", fops.launches_by_route(), {"sm90": 0, "simt": 2})
    rep["f32_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  DeepSeek-V3 full width, 2 layers, float32 ({cfg32.param_count():,} parameters and "
        f"the MTP module), capacity factor {cfg32.capacity_factor}: decode vs forward relative "
        f"max error {rep['f32_decode_vs_forward_rel']:.3g} (< 2e-3); peak "
        f"{rep['f32_peak_mem_bytes'] / 2**30:.3f} GiB; {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=device)
    params = model.init(seed)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab, (1, MOE_SEQ), generator=g, device=device)
    fwd_s = []
    for i in range(2):
        fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, mtp_logits, aux = lm_forward_mtp(params, tokens, cfg)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        if i == 0:
            rep["launches_by_route"] = fops.launches_by_route()
            _want_flash("DeepSeek-V3 lm_forward_mtp", rep["launches_by_route"],
                        {"sm90": cfg.n_layers + 1, "simt": 0})
        want = (1, MOE_SEQ, cfg.padded_vocab)
        if (logits.shape != want or mtp_logits.shape != want
                or not bool(torch.isfinite(logits[..., :cfg.vocab]).all())
                or not bool(torch.isfinite(mtp_logits[..., :cfg.vocab]).all())
                or not bool(torch.isfinite(aux)) or float(aux) <= 0):
            raise AssertionError(f"DeepSeek-V3 lm_forward_mtp: {tuple(logits.shape)}, "
                                 f"{tuple(mtp_logits.shape)}, aux {float(aux)}: not finite / "
                                 "of the expected shape")
        rep["aux"] = float(aux)
        del logits, mtp_logits
    rep["forward_s"] = fwd_s
    rep["forward_tokens_per_s"] = MOE_SEQ / min(fwd_s)
    rep["forward_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  DeepSeek-V3 {cfg.n_layers} layers ({cfg.param_count():,} bf16 parameters by "
        f"param_count, and the MTP module; init {rep['init_s']:.2f} s): lm_forward_mtp of "
        f"{MOE_SEQ} tokens {fwd_s[0]:.3f} s cold, {fwd_s[1]:.3f} s warm; flash_attention "
        f"{rep['launches_by_route']}; aux {rep['aux']:.4f}; logits and MTP logits finite; peak "
        f"{rep['forward_peak_mem_bytes'] / 2**30:.3f} GiB; cut: " + "; ".join(reduced))

    batch, prompt_len, n_new = MLA_SERVE
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g, device=device)
    rep["serve"] = {}
    answers = {}
    fops.reset_launches()
    for absorb in (False, True):
        c = dataclasses.replace(cfg, mla_absorb=absorb)
        inst = new_instance(c, params, batch=batch, max_len=prompt_len + n_new, device=device)
        toks, _pre, _last, prefill_s, decode_s = serve_timed(torch, np, inst, prompts, n_new)
        if toks.shape != (batch, n_new) or inst.pos != prompt_len + n_new:
            raise AssertionError(f"DeepSeek-V3 serving gave {toks.shape} at pos {inst.pos}")
        key = "absorbed" if absorb else "re-expanded"
        answers[key] = toks
        rep["serve"][key] = {"prefill_s": prefill_s, "decode_s": decode_s,
                             "decode_tokens_per_s": batch * n_new / decode_s,
                             "tokens": toks.tolist()}
        log(f"  DeepSeek-V3 serve ({key} MLA decode): {batch} x {prompt_len}-token prompts, "
            f"{n_new} new tokens: prefill {prefill_s:.3f} s, decode {decode_s:.3f} s "
            f"({batch * n_new / decode_s:.1f} tokens/s); first tokens {toks[:, :6].tolist()}")
        del inst
    _want_flash("DeepSeek-V3 serving", fops.launches_by_route(), {"sm90": 0, "simt": 0})
    agree = float((answers["absorbed"] == answers["re-expanded"]).mean())
    rep["serve"]["token_agreement"] = agree
    rep["peak_mem_bytes"] = max(rep["f32_peak_mem_bytes"], torch.cuda.max_memory_allocated())
    log(f"  DeepSeek-V3: absorbed and re-expanded decodes agree on {agree:.3f} of the tokens "
        f"(printed, not asserted); peak {rep['peak_mem_bytes'] / 2**30:.3f} GiB")
    del params, model
    torch.cuda.empty_cache()
    return rep


def workload_cell(torch, np, name: str, seed: int, device) -> dict:
    """A workload of ``scripts/workloads.py`` built on the card, published
    with the fused sweep and restored: bit-identical, every page verified,
    launches exact; its zero/hot/cold shares and working set equal to the
    CPU run's."""
    import workloads

    from repro_torch.core import HierarchicalPool, build_snapshot, free_snapshot
    from repro_torch.kernels.snapshot_fuse import ops

    def shares(w):
        zero = w.image.zero_page_bitmap()
        hot = np.zeros(zero.size, bool)
        hot[w.profile.working_set] = True
        return {"zero": float(zero.mean()), "hot": float((hot & ~zero).mean()),
                "cold": float((~hot & ~zero).mean()), "pages": int(zero.size)}

    t0 = time.perf_counter()
    w = workloads.build_workload(name, seed=seed, device=device)
    cpu = workloads.build_workload(name, seed=seed, device="cpu")
    rep = {"arch": w.wdef.arch, "build_s": time.perf_counter() - t0, "shares": shares(w),
           "cpu_shares": shares(cpu)}
    if rep["shares"] != rep["cpu_shares"] or not np.array_equal(
            w.profile.working_set, cpu.profile.working_set):
        raise AssertionError(f"{name}: the card's image classes {rep['shares']} differ "
                             f"from the CPU run's {rep['cpu_shares']}")
    del cpu
    counted = data_plane_wrappers()     # the shares' zero scan above is a check, not the path
    for k in counted.values():
        k.launches = 0
    n = w.image.manifest.total_pages
    pool = HierarchicalPool(cxl_capacity=(n + 64) * PAGE, rdma_capacity=(n + 64) * PAGE,
                            device=device)
    regions = build_snapshot(pool, w.image, w.profile.working_set, name,
                             publish_fn=ops.make_fused_publish_fn())
    r = restore_once(torch, pool, regions, w.image.buf, w.image.manifest, ops.FusedScatter())
    check_routes(f"{name} restore", r["walk_routes"])
    launches = {n: k.launches for n, k in counted.items()}
    want = {"fused_publish": 1, "fused_restore": 2 * r["walk_routes"]["batched"],
            "zero_detect": 0, "page_checksum": 0, "page_gather": 0, "page_scatter": 0}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    free_snapshot(pool, regions)
    rep.update(launches=launches, restore_s=r["restore_s"], pages_verified=r["pages_verified"],
               n_hot=regions.n_hot, n_cold=regions.n_cold, n_zero=regions.n_zero)
    s, c = rep["shares"], rep["cpu_shares"]
    log(f"  {name} workload ({w.wdef.arch}, {s['pages']} pages): zero {s['zero']:.4f} hot "
        f"{s['hot']:.4f} cold {s['cold']:.4f} on the card, {c['zero']:.4f} / {c['hot']:.4f} / "
        f"{c['cold']:.4f} on the CPU (equal); fused publish and restore "
        f"{r['restore_s'] * 1e3:.2f} ms: bit-identical, pages verified {r['pages_verified']}; "
        f"launches {launches}")
    return rep


def moe_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """The MoE family on the card (see the module docstring): the flash
    forward at both full-width shapes and the Dk != Dv backward, cell (10)
    OLMoE-1B-7B, cell (11) DeepSeek-V3 on two layers, and the recognition
    workload's image, each with its launch counts reset just before it."""
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rep = {"flash": check_flash_moe(torch, device, seed),
           "backward": check_flash_bwd_mla(torch, device, seed)}
    rep["kernel_checks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["olmoe"] = olmoe_cell(torch, np, seed, device, out_dir)
    rep["olmoe"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["deepseek"] = deepseek_cell(torch, np, seed, device, out_dir)
    rep["deepseek"]["wall_s"] = time.perf_counter() - t0
    # the forward's flash launches run at the timed MLA shape exactly
    ds, mla_ms = rep["deepseek"], rep["flash"]["shapes"]["mla"]["ms"]
    n_flash = sum(ds["launches_by_route"].values())
    ds["flash_ms_est"] = n_flash * mla_ms
    ds["flash_share_est"] = ds["flash_ms_est"] / 1e3 / min(ds["forward_s"])
    log(f"  DeepSeek-V3 lm_forward_mtp: its {n_flash} flash launches at {mla_ms:.4f} ms "
        f"each (the timed MLA shape) "
        f"make {ds['flash_ms_est']:.3f} ms, {ds['flash_share_est']:.4f} of the "
        f"{min(ds['forward_s']):.4f} s warm forward")
    t0 = time.perf_counter()
    rep["recognition"] = workload_cell(torch, np, "recognition", seed, device)
    rep["recognition"]["wall_s"] = time.perf_counter() - t0
    log(f"  moe walls: kernel checks {rep['kernel_checks_s']:.2f} s, OLMoE "
        f"{rep['olmoe']['wall_s']:.2f} s, DeepSeek-V3 {rep['deepseek']['wall_s']:.2f} s, "
        f"recognition {rep['recognition']['wall_s']:.2f} s")
    return rep


# ----------------------------------------------------------------------------
# families: the VLM, xLSTM, Zamba2 and SeamlessM4T served at full width
# ----------------------------------------------------------------------------

def family_flash(cfg, decode: bool = False) -> int:
    """Flash launches of one forward of ``cfg`` (or, ``decode``, one decode
    step): one a self-attention layer (the hybrid's shared block once a
    group), and the encoder-decoder's cross attention once a decoder layer
    in both."""
    if cfg.is_encdec:
        return cfg.n_dec_layers if decode else cfg.n_enc_layers + 2 * cfg.n_dec_layers
    if decode or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def family_cell(torch, np, arch: str, seed: int, device, out_dir: Path) -> dict:
    """One family model at full width from seeded random weights (cut as
    ``FAMILY_CELLS`` says): one forward of ``FAMILY_CELLS[arch]["seq"]``
    tokens (and as many seeded vision embeds or frames), its flash launches
    exact and on their route, finite logits; ``FAMILY_SERVE`` requests
    through the serving engine, prefill and decode timed apart, flash
    launches exact (the encoder-decoder's cross attention at Sq = 1 a layer
    a step); a profiled forward and four decode steps; then the float32
    model's decode against its forward (< 2e-3, launches exact)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import build
    from repro_torch.serve import new_instance

    spec = FAMILY_CELLS[arch]
    walls, t_stage = {}, [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - t_stage[0]
        t_stage[0] = now

    full = get_config(arch)
    cut = spec.get("cut", {})
    cfg = dataclasses.replace(full, name=f"{arch}-cell", **cut)
    reduced = [f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items()]
    seq = spec["seq"]
    route = ("sm90" if cfg.compute_dtype == "bfloat16" and (cfg.head_dim,) * 2 in fops.SM90_DK_DV
             else "simt")
    rep = {"arch": arch, "family": full.family, "d_model": cfg.d_model,
           "n_layers": cfg.n_layers, "param_count": cfg.param_count(),
           "param_dtype": cfg.param_dtype, "reduced": reduced, "seq": seq}
    g = torch.Generator(device=device)
    g.manual_seed(seed + spec["seed"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device=device)
    params = model.init(seed)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, seq), generator=g, device=device)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(1, cfg.vision_prefix, cfg.d_model, generator=g,
                                             device=device).to(cfg.cdtype())
    if cfg.is_encdec:
        batch["frames"] = torch.randn(1, seq, cfg.d_model, generator=g,
                                      device=device).to(cfg.cdtype())
    want_fwd = {"sm90": 0, "simt": 0}
    want_fwd[route] = family_flash(cfg)
    fwd_s = []
    for i in range(spec["forwards"]):
        fops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.forward(params, batch)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        _want_flash(f"{arch} forward", fops.launches_by_route(), want_fwd)
        if (logits.shape != (1, seq, cfg.padded_vocab) or logits.dtype != torch.float32
                or not bool(torch.isfinite(logits[..., :cfg.vocab]).all())):
            raise AssertionError(f"{arch} forward: logits {tuple(logits.shape)} "
                                 f"{logits.dtype}: not finite / of the expected shape")
        del logits
    rep["launches_by_route"] = want_fwd
    rep["forward_s"] = fwd_s
    rep["forward_tokens_per_s"] = seq / min(fwd_s)
    rep["forward_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log(f"  {arch}: {cfg.param_count():,} {cfg.param_dtype} parameters, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model} (init {rep['init_s']:.2f} s); Model.forward of {seq} tokens: "
        + ", ".join(f"{t:.3f}" for t in fwd_s) + f" s ({rep['forward_tokens_per_s']:.0f} "
        f"tokens/s); flash_attention {want_fwd}; logits finite; peak "
        f"{rep['forward_peak_mem_bytes'] / 2**30:.3f} GiB"
        + (f"; cut: {'; '.join(reduced)}" if reduced else ""))
    stage("init_and_forwards")
    # device activity only: the xLSTM forward's ~260 k launches take the profiler
    # ~75 us each to record and read back, twice that with every host op
    rep["profile_forward"] = profile_model(
        torch, lambda: model.forward(params, batch), f"{arch}_forward", out_dir,
        host_ops=False)
    stage("profile_forward")

    n_req, prompt_len, n_new = FAMILY_SERVE
    prompts = torch.randint(0, cfg.vocab, (n_req, prompt_len), generator=g, device=device)
    want_step = {"sm90": 0, "simt": 0}
    want_step[route] = family_flash(cfg, decode=True) * (prompt_len + n_new)
    fops.reset_launches()
    inst = new_instance(cfg, params, batch=n_req, max_len=prompt_len + n_new, device=device)
    toks, _pre, _last, prefill_s, decode_s = serve_timed(torch, np, inst, prompts, n_new)
    if toks.shape != (n_req, n_new) or inst.pos != prompt_len + n_new:
        raise AssertionError(f"{arch} serving gave {toks.shape} at pos {inst.pos}")
    _want_flash(f"{arch} serving", fops.launches_by_route(), want_step)
    rep["serve"] = {"batch": n_req, "prompt_len": prompt_len, "new_tokens": n_new,
                    "prefill_s": prefill_s, "decode_s": decode_s,
                    "prefill_tokens_per_s": n_req * prompt_len / prefill_s,
                    "decode_tokens_per_s": n_req * n_new / decode_s,
                    "launches_by_route": want_step, "first_tokens": toks[:, :4].tolist()}
    log(f"  {arch} serve: {n_req} requests x {prompt_len}-token prompts, {n_new} new tokens: "
        f"prefill {prefill_s:.3f} s ({rep['serve']['prefill_tokens_per_s']:.1f} tokens/s, a "
        f"decode step a prompt token), decode {decode_s:.3f} s "
        f"({rep['serve']['decode_tokens_per_s']:.1f} tokens/s); flash_attention {want_step}; "
        f"first tokens {toks[:, :4].tolist()}")
    del inst, _pre, _last
    stage("serve")
    inst = new_instance(cfg, params, batch=n_req, max_len=8, device=device)
    tok = prompts[:, :1].to(torch.int32)
    for _ in range(2):
        inst.decode(tok)

    def four_steps():
        for _ in range(4):
            inst.decode(tok)
    rep["profile_decode"] = profile_model(torch, four_steps, f"{arch}_decode", out_dir,
                                          host_ops=False)
    rep["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del inst, params, model, batch, four_steps
    torch.cuda.empty_cache()
    stage("profile_decode")

    # decode against forward in float32 (tests/test_models.py's parity)
    cfg32 = dataclasses.replace(full, name=f"{arch}-f32", compute_dtype="float32",
                                param_dtype="float32", **spec.get("parity_cut", {}))
    pseq = spec["parity_seq"]
    # the forward, the encoder once more for the cross K/V, a decode step a token
    want32 = {"sm90": 0, "simt": family_flash(cfg32) + cfg32.n_enc_layers
              + family_flash(cfg32, decode=True) * pseq}
    fops.reset_launches()
    rep["f32_decode_vs_forward_rel"] = decode_vs_forward(torch, cfg32, seed + 1, device, g,
                                                         seq=pseq)
    _want_flash(f"{arch} float32 parity", fops.launches_by_route(), want32)
    rep["f32_parity"] = {"n_layers": cfg32.n_layers, "seq": pseq,
                         "param_count": cfg32.param_count(), "launches_by_route": want32}
    stage("f32_parity")
    rep["walls_s"] = walls
    log(f"  {arch} float32, {cfg32.n_layers} layers ({cfg32.param_count():,} parameters), "
        f"{pseq} tokens: decode vs forward relative max error "
        f"{rep['f32_decode_vs_forward_rel']:.3g} (< 2e-3); flash_attention {want32}")
    log(f"  {arch} walls: " + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; peak device memory {rep['peak_mem_bytes'] / 2**30:.3f} GiB")
    return rep


def families_phase(torch, np, seed: int, device, out_dir: Path) -> dict:
    """The VLM, xLSTM, Zamba2 and SeamlessM4T families on the card (see the
    module docstring): the flash forward at their new shapes and the
    backward at Zamba2's (80, 80), each model's
    cell, ``torch.cuda.memory_allocated()`` back to its start after each,
    and their four workloads' images published and restored."""
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rep = {"flash": check_flash_shapes(torch, device, seed + 59, FAMILY_FLASH_SHAPES,
                                       FAMILY_SIMT_TIMED),
           "backward": check_flash_bwd_d80(torch, device, seed)}
    rep["flash_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for arch in FAMILY_CELLS:
        t0 = time.perf_counter()
        rep[arch] = family_cell(torch, np, arch, seed, device, out_dir)
        rep[arch]["wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        if torch.cuda.memory_allocated() != base:
            raise AssertionError(f"{arch}: {torch.cuda.memory_allocated() - base} bytes of device "
                                 "memory outlive the cell")
    rep["workloads"] = {}
    t0 = time.perf_counter()
    for name in FAMILY_WORKLOADS:
        rep["workloads"][name] = workload_cell(torch, np, name, seed, device)
    rep["workloads_s"] = time.perf_counter() - t0
    log(f"  families walls: flash {rep['flash_s']:.2f} s, "
        + ", ".join(f"{a} {rep[a]['wall_s']:.2f} s" for a in FAMILY_CELLS)
        + f", workloads {rep['workloads_s']:.2f} s; device memory back to its start after "
        "each model")
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke.json"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from repro_torch.core import (ArrayExtent, HierarchicalPool, Instance, Manifest,
                                  RestoreEngine, SnapshotReader, StateImage, TimeLedger,
                                  build_snapshot, free_snapshot, runs_of_indices)
    from repro_torch.kernels import build
    from repro_torch.kernels.snapshot_fuse import ops, ref

    device = torch.device("cuda", 0)
    n = PAPER_INSTANCE_PAGES
    report = {"seed": args.seed, "pages": n, "phase_s": {}}
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        report["phase_s"][name] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase {name}: {report['phase_s'][name]:.2f} s")

    # 1. card
    card = card_line()
    report["card"] = card
    report["torch"] = f"{torch.__version__} cuda {torch.version.cuda}"
    log(f"card: {card}  ({report['torch']})")
    phase_done("card")

    # 2. build
    t0 = time.perf_counter()
    compiled = build.build()
    report["build_s"] = time.perf_counter() - t0
    report["build_s_by_library"] = compiled
    report["build_logs"] = dict(build.build_logs)
    log(f"build: {report['build_s']:.2f} s for {sorted(compiled) or 'cached libraries'}, in "
        f"parallel: {', '.join(f'{n} {t:.2f} s' for n, t in sorted(compiled.items()))}")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    phase_done("build")

    # 3. image
    t0 = time.perf_counter()
    buf, hot_mask = make_image(n, args.seed, device)
    torch.cuda.synchronize()
    manifest = Manifest([ArrayExtent("guest", 0, n * PAGE, (n * PAGE,), "uint8")], n)
    image = StateImage(manifest, buf)
    hot_np = hot_mask.cpu().numpy()
    zero_np = ~image.pages_matrix().any(dim=1).to(torch.bool).cpu().numpy()
    working_set = np.flatnonzero(hot_np)

    def runs_of(mask):
        return runs_of_indices(np.flatnonzero(mask))[:, 1]

    comp = {"zero": float(zero_np.mean()), "hot": float((hot_np & ~zero_np).mean()),
            "cold": float((~hot_np & ~zero_np).mean()),
            "hot_runs": int(runs_of(hot_np).size),
            "mean_hot_run": float(runs_of(hot_np).mean()),
            "cold_runs": int(runs_of(~hot_np & ~zero_np).size),
            "zero_runs": int(runs_of(zero_np).size),
            "make_s": time.perf_counter() - t0}
    report["composition"] = comp
    log(f"image: {n} pages ({n * PAGE / 2**30:.3f} GiB) zero={comp['zero']:.4f} "
        f"hot={comp['hot']:.4f} cold={comp['cold']:.4f} hot_runs={comp['hot_runs']} "
        f"mean_hot_run={comp['mean_hot_run']:.3f} cold_runs={comp['cold_runs']} "
        f"zero_runs={comp['zero_runs']}")
    if not (0.469 <= comp["zero"] <= 0.907 and 0.04 <= comp["hot"] <= 0.07):
        raise AssertionError(f"composition outside the paper's range: {comp}")
    cold_idx = np.flatnonzero(~hot_np & ~zero_np)
    if zero_np[working_set].any():
        raise AssertionError("a hot page of the image is all zero")
    phase_done("image")

    # 4. kernels against their plain versions
    log("kernels:")
    rng = np.random.default_rng(args.seed)
    small = []
    for name, rows, zero_every, ws_all in (("N=0", 0, 3, False), ("ragged N=37", 37, 3, False),
                                           ("N=1000", 1000, 3, False),
                                           ("N=3T+5", 3 * ops.PUBLISH_TILE_PAGES + 5, 3, False),
                                           ("all-zero", 64, 1, False),
                                           ("all-hot", 64, 0, True)):
        p = torch.from_numpy(rng.integers(0, 256, (rows, PAGE), dtype=np.uint8)).to(device)
        if zero_every:
            p[::zero_every] = 0
        if zero_every == 3:
            p[1::7] = 0xFF                                # all-ones lanes: the wrap case
        w = (torch.ones(rows, dtype=torch.bool, device=device) if ws_all
             else torch.from_numpy(rng.random(rows) < 0.3).to(device))
        small.append((name, p, w))
    ws_full = torch.zeros(n, dtype=torch.bool, device=device)
    ws_full[torch.from_numpy(working_set).to(device)] = True
    pm = image.pages_matrix()
    pub_err = check_publish(torch, ops, ref, small + [("1.5 GiB image", pm, ws_full)])
    res_err = check_restore(torch, np, ops, ref, n, device)

    # timings at the main path's shapes
    nnz = int((~zero_np).sum())
    pub = time_publish(torch, ops, ref, pm, ws_full, nnz)
    usage = res_usage(build.lib_path("fused_publish"), ("publish_kernel",))
    pub["resources"] = usage.get("publish_kernel", usage)
    report["publish"] = pub
    log(f"  fused_publish  {pub['ms']:.4f} ms a launch ({pub['bound_ms'] / pub['ms']:.3f} of the "
        f"bound {pub['bound_ms']:.4f} ms by {pub['bound_by']}); through the wrapper "
        f"{pub['wrapper_ms']:.4f} ms; plain {pub['plain_ms']:.4f} ms; at {n} pages; "
        f"publish_kernel {pub['resources']}")
    table = ops.fused_publish(pm, ws_full).checksums      # guest-indexed, as a snapshot's
    walks = {"hot": walk_segments(torch, np, pm, working_set, RestoreEngine.HOT_CHUNK_PAGES),
             "cold": walk_segments(torch, np, pm, cold_idx)}
    res_err = max(res_err, check_row_lists(torch, np, pm, table, walks))
    row_lists = time_row_lists(torch, np, pm, table, walks, cold_idx, device)
    report["row_lists"] = row_lists
    del walks, table
    torch.cuda.empty_cache()
    fused_csum = ops.fused_publish(pm, ws_full).checksums
    row_err = check_row_kernels(torch, np, pm, fused_csum, working_set, cold_idx, device)
    del fused_csum
    row_t = time_row_kernels(torch, pm, working_set, cold_idx, device)
    report["row_kernel_timings"] = row_t
    phase_done("kernels")

    # 5. main path, counts reset just before it
    from repro_torch import kernels as kmod

    row_kernels = {name: getattr(kmod, name) for name in ROW_KERNELS}
    for k in (ops.fused_publish, ops.fused_restore, *row_kernels.values()):
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    pool = HierarchicalPool(device="cuda")
    t0 = time.perf_counter()
    regions = build_snapshot(pool, image, working_set, "smoke",
                             publish_fn=ops.make_fused_publish_fn())
    torch.cuda.synchronize()
    publish_s = time.perf_counter() - t0
    ledger = TimeLedger()
    reader = SnapshotReader(regions, pool.host_view("host0", ledger), pool.rdma)
    reader.invalidate_cxl()
    inst = Instance(StateImage.empty_like(image.manifest, device="cuda"), ledger)
    engine = RestoreEngine(reader, inst, scatter_fn=ops.FusedScatter())
    t0 = time.perf_counter()
    engine.pre_install_hot()
    t_hot = time.perf_counter()
    engine.install_all_sync()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    launches = {"fused_publish": ops.fused_publish.launches,
                "fused_restore": ops.fused_restore.launches}
    launches_private_row = {name: k.launches for name, k in row_kernels.items()}
    n_cold_runs = int(reader.cold_runs().shape[0])
    routes = engine.walk_routes
    want_restore = 2 * routes["batched"]     # a walk: one verify-only launch, one install
    verified = inst.scatter_fn.stats["pages_verified"]
    main = {"publish_s": publish_s, "restore_s": restore_s,
            "pre_install_hot_s": t_hot - t0, "n_hot": regions.n_hot,
            "n_cold": regions.n_cold, "n_zero": regions.n_zero,
            "cold_runs": n_cold_runs, "launches": launches, "walk_routes": routes,
            "expected_restore_launches": want_restore, "pages_verified": verified,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "peak_mem_above_start_bytes": torch.cuda.max_memory_allocated() - base_mem,
            "modeled_ledger_s": dict(ledger.seconds),
            "modeled_total_s": ledger.total()}
    report["main"] = main
    if not torch.equal(inst.image.buf, image.buf):
        raise AssertionError("restored image differs from the published one")
    if verified != regions.n_hot + regions.n_cold:
        raise AssertionError(f"{verified} pages verified, want {regions.n_hot + regions.n_cold}")
    check_routes("private main path", routes)
    if launches["fused_publish"] != 1 or launches["fused_restore"] != want_restore:
        raise AssertionError(f"launch counts {launches}, want publish 1, "
                             f"restore {want_restore}")
    log(f"main path: publish {publish_s * 1e3:.2f} ms, restore {restore_s * 1e3:.2f} ms "
        f"(hot pre-install {main['pre_install_hot_s'] * 1e3:.2f} ms) wall; "
        f"n_hot={regions.n_hot} n_cold={regions.n_cold} n_zero={regions.n_zero} "
        f"cold_runs={n_cold_runs}")
    log(f"  bit-identical restore: True; pages verified {verified}; launches {launches}; "
        f"walks {routes}")
    log(f"  peak device memory {main['peak_mem_bytes'] / 2**30:.3f} GiB")
    log(f"  modeled (paper cost model, not device time): total "
        f"{main['modeled_total_s'] * 1e3:.4f} ms {json.dumps(main['modeled_ledger_s'])}")
    main["routes_in_turns"] = route_turns(
        torch, "private", lambda scatter: restore_once(
            torch, pool, regions, image.buf, image.manifest, scatter),
        ops.FusedScatter, PerExtentScatter)
    phase_done("main")

    del inst, engine, reader
    free_snapshot(pool, regions)
    del pool
    torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    report["profile"] = profile_main_path(torch, HierarchicalPool(device="cuda"), image,
                                          working_set, ops, out.parent)
    phase_done("profile")

    # 7. the dedup fleet, counts reset inside just before it
    log("dedup fleet:")
    report["dedup"] = dedup_phase(torch, np, buf, working_set, cold_idx, manifest, args.seed,
                                  out.parent)
    torch.cuda.empty_cache()
    phase_done("dedup")

    # 8. the pod's control plane, counts reset inside just before it
    log("pod:")
    report["pod"] = pod_phase(torch, np, image, working_set, cold_idx, args.seed, out.parent)
    log_pod(report["pod"], card)
    torch.cuda.empty_cache()
    phase_done("pod")

    # 9. the multi-pod topology at the same image, counts reset inside just before it
    log("topology:")
    report["topology"] = topology_phase(torch, np, image, working_set, cold_idx, args.seed)
    log_topology(report["topology"], card)
    torch.cuda.empty_cache()
    phase_done("topology")

    # 10. the simulator's scenario matrix, on the card against the CPU
    log("sim:")
    report["sim"] = sim_phase(torch)
    log_sim(report["sim"], card)
    torch.cuda.empty_cache()
    phase_done("sim")
    log(f"phases topology + sim: {report['phase_s']['topology'] + report['phase_s']['sim']:.2f} s")

    # 11. re-curation at the 1.5 GiB image, counts reset inside just before it
    log("recurate:")
    report["recurate"] = recurate_phase(torch, np, image, working_set, cold_idx, args.seed)
    torch.cuda.empty_cache()
    phase_done("recurate")

    # 12. fleet serving: the bench twin against the committed results, a pod
    # at the card's scale and the A4d check, counts reset before each part
    log("fleet:")
    report["fleet"] = fleet_phase(torch, np, image, working_set, args.seed, out.parent)
    torch.cuda.empty_cache()
    phase_done("fleet")

    # 13. the evaluation benches' twins against their committed files, and the
    # fault sweeps at the 1.5 GiB image, counts reset before each
    log("benches:")
    report["benches"] = benches_phase(torch, np, image, working_set, out.parent)
    torch.cuda.empty_cache()
    phase_done("benches")

    # 14. Phi-4-mini's cold start from the pool, counts reset inside just before it
    log("coldstart:")
    del pm, image, buf
    torch.cuda.empty_cache()
    report["coldstart"] = coldstart_phase(torch, np, args.seed, device, out.parent)
    phase_done("coldstart")

    # 15. the model: the flash kernel's checks and timings, then Phi-4-mini's
    # prefill forward (counts reset inside just before it), serving and parity
    log("model:")
    report["flash"] = check_flash(torch, device, args.seed)
    report["model"] = model_phase(torch, np, args.seed, device, out.parent)
    phase_done("model")

    # 16. the MoE family: the flash kernels at its shapes, OLMoE-1B-7B served at
    # full width and depth, DeepSeek-V3 on two layers, the recognition image
    # (counts reset inside just before each path)
    log("moe:")
    report["moe"] = moe_phase(torch, np, args.seed, device, out.parent)
    phase_done("moe")

    # 17. the VLM, xLSTM, Zamba2 and SeamlessM4T families: the flash kernels at their
    # shapes, each model served at full width, their four workloads' images (counts reset
    # inside just before each path)
    log("families:")
    report["families"] = families_phase(torch, np, args.seed, device, out.parent)
    phase_done("families")

    # 18. training: the attention backward's checks and timings, Phi-4-mini's
    # train steps, checkpoint, crash and resume, the quickstart twin (counts
    # reset inside just before each path)
    log("train:")
    report["train"] = train_phase(torch, np, args.seed, device, out.parent)
    phase_done("train")

    # 19. sharding: compressed_psum over xLSTM-125M's gradients on a one-rank
    # NCCL group, the elastic-restore twin at full width (counts reset inside
    # just before its path), one dry-run cell in a subprocess
    log("sharding:")
    report["sharding"] = sharding_phase(torch, np, args.seed, device, out.parent)
    phase_done("sharding")

    dedup_launches = report["dedup"]["launches"]
    pod_launches = report["pod"]["launches"]
    topo_launches = report["topology"]["launches"]
    sim_launches = report["sim"]["launches"]
    recurate_launches = report["recurate"]["launches"]
    coldstart_launches = report["coldstart"]["launches"]
    fleet_launches = report["fleet"]["launches"]
    bench_launches = report["benches"]["launches"]
    coldstart_err = report["coldstart"]["max_abs_err"]
    fam = report["families"]
    fam_launches = {k: sum(w["launches"][k] for w in fam["workloads"].values())
                    for k in ("fused_publish", "fused_restore")}
    cold, hot, store = row_lists["cold"], row_lists["hot"], row_lists["store_write"]
    kernels = [
        {"name": "fused_publish", "route": "cuda", "source": f"{CSRC}/fused_publish.cu",
         "replaces": PUBLISH_TPU, "launches": launches["fused_publish"],
         "launches_by_path": {"private": launches["fused_publish"],
                              "dedup": dedup_launches["fused_publish"],
                              "pod": pod_launches["fused_publish"],
                              "topology": topo_launches["fused_publish"],
                              "sim": sim_launches["fused_publish"],
                              "recurate": recurate_launches["fused_publish"],
                              "fleet": fleet_launches["fused_publish"],
                              "benches": bench_launches["fused_publish"],
                              "coldstart": coldstart_launches["fused_publish"],
                              "families": fam_launches["fused_publish"],
                              "sharding": report["sharding"]["elastic"]["launches"][
                                  "fused_publish"]},
         "bit_equal": True,
         "max_abs_err": max(pub_err, coldstart_err["fused_publish"]), "ms": pub["ms"],
         "plain_ms": pub["plain_ms"],
         "bound_ms": pub["bound_ms"], "bound_by": pub["bound_by"], "library_ms": None,
         "wrapper_ms": pub["wrapper_ms"], "resources": pub["resources"],
         "shape": f"{n} pages, {nnz} non-zero, one launch"},
        {"name": "fused_restore", "route": "cuda", "source": f"{CSRC}/fused_restore.cu",
         "replaces": RESTORE_TPU, "launches": launches["fused_restore"],
         "launches_by_path": {"private": launches["fused_restore"],
                              "dedup": dedup_launches["fused_restore"],
                              "pod": pod_launches["fused_restore"],
                              "topology": topo_launches["fused_restore"],
                              "sim": sim_launches["fused_restore"],
                              "recurate": recurate_launches["fused_restore"],
                              "fleet": fleet_launches["fused_restore"],
                              "benches": bench_launches["fused_restore"],
                              "coldstart": coldstart_launches["fused_restore"],
                              "families": fam_launches["fused_restore"],
                              "sharding": report["sharding"]["elastic"]["launches"][
                                  "fused_restore"]},
         "bit_equal": True, "max_abs_err": res_err,
         "ms": cold["install"]["ms"], "plain_ms": cold["plain_ms"],
         "bound_ms": cold["install"]["bound_ms"], "bound_by": cold["install"]["bound_by"],
         "library_ms": None,
         "shape": f"private cold walk, verified install, {cold['rows']} rows from "
                  f"{cold['segments']} segments",
         "verify_only_ms": cold["verify_only"]["ms"],
         "verify_only_bound_ms": cold["verify_only"]["bound_ms"],
         "hot_walk_ms": hot["install"]["ms"], "hot_walk_bound_ms": hot["install"]["bound_ms"],
         "flush_wrapper_ms": cold["flush_wrapper_ms"]},
    ]
    for name, tpu in ROW_KERNELS.items():
        if name == "page_scatter":
            r = dict(store, ms=store["ms"]["kernel"], library_ms=store["ms"]["library"],
                     walk_ms=cold["scatter"]["ms"], walk_bound_ms=cold["scatter"]["bound_ms"])
        else:
            r = row_t[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu", "replaces": tpu,
            "launches": dedup_launches[name],
            "launches_by_path": {"private": launches_private_row[name],
                                 "dedup": dedup_launches[name], "pod": pod_launches[name],
                                 "topology": topo_launches[name], "sim": sim_launches[name],
                                 "recurate": recurate_launches[name],
                                 "fleet": fleet_launches[name],
                                 "benches": bench_launches[name],
                                 "coldstart": coldstart_launches[name]},
            "bit_equal": True,
            "max_abs_err": max(row_err[name], coldstart_err.get(name, 0)), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **({} if name != "page_scatter" else
               {"walk_ms": r["walk_ms"],
                "walk_bound_ms": r["walk_bound_ms"]})})
    r = report["flash"]["timing"]
    by_route = report["model"]["launches_by_route"]
    moe = report["moe"]

    def at_shape(t):
        return {k: t[k] for k in ("shape", "route", "ms", "simt_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "issued_flop") if k in t}

    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SRC["sm90"],
        "replaces": FLASH_TPU, "launches": by_route["sm90"],
        "launches_by_route": by_route,
        "launches_by_path": {"prefill_forward": report["model"]["launches"],
                             "benches": report["benches"]["launches_flash"],
                             "olmoe_forward": moe["olmoe"]["launches_by_route"],
                             "deepseek_mtp_forward": moe["deepseek"]["launches_by_route"],
                             **{f"{a}_forward": fam[a]["launches_by_route"] for a in FAMILY_CELLS},
                             "seamless_serving": fam["seamless-m4t-medium"]["serve"][
                                 "launches_by_route"],
                             "train": report["train"]["launches"]["flash_attention"]},
        "bit_equal": False, "tolerance": report["flash"]["tolerance"],
        "max_abs_err": max(report["flash"]["max_abs_err"],
                           *(t["max_abs_err"] for t in moe["flash"]["shapes"].values()),
                           *(t["max_abs_err"] for t in fam["flash"]["shapes"].values())),
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "simt_ms": r["simt_ms"], "simt_source": FLASH_SRC["simt"], "shape": r["shape"],
        "at_moe_shapes": {n: at_shape(t) for n, t in moe["flash"]["shapes"].items()},
        "at_family_shapes": {n: at_shape(t) for n, t in fam["flash"]["shapes"].items()},
        "resources": {**moe["flash"]["resources"],
                      **fam["backward"]["resources"]["flash_attention_sm90"]}})
    tr = report["train"]
    b = tr["backward"]["timing"]
    bwd_replaces = (f"none: the backward of {FLASH_TPU}, which the JAX package gets by "
                    "differentiating its reference")
    qs_bwd = tr["quickstart"]["launches"]["bwd_by_route"]
    train_bwd = tr["launches"]["flash_attention_bwd_by_route"]
    # the tensor-core kernel's path is the bf16 train step; the SIMT
    # kernel's, the quickstart twin (32-wide heads)
    for route, name, src, ms, launches in (
            ("sm90", "flash_attention_bwd_sm90", "bwd_sm90", b["ms"], train_bwd["sm90"]),
            ("simt", "flash_attention_bwd", "bwd", b["simt_ms"], qs_bwd["simt"])):
        if launches == 0:
            raise AssertionError(f"{name}: launched no time on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": FLASH_SRC[src],
            "replaces": bwd_replaces, "launches": launches,
            "launches_by_path": {"train": train_bwd[route], "quickstart": qs_bwd[route]},
            "bit_equal": False, "deterministic": True, "tolerance": tr["backward"]["tolerance"],
            "max_abs_err": max(tr["backward"]["max_abs_err"][route],
                               moe["backward"]["max_abs_err"][route],
                               fam["backward"]["max_abs_err"][route]),
            "ms": ms, "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": b["library_ms"], "shape": b["shape"],
            **({"at_mla_shape": at_shape(moe["backward"]["timing"]),
                "at_zamba2_shape": at_shape(fam["backward"]["timing"]),
                "resources": {**moe["backward"]["resources"],
                              **fam["backward"]["resources"]["flash_attention_bwd_sm90"]}}
               if route == "sm90" else {})})
    report["kernels"] = kernels
    report["smoke_s"] = sum(report["phase_s"].values())
    log(f"smoke: {report['smoke_s']:.2f} s over {len(report['phase_s'])} phases on {card}")
    out.write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
