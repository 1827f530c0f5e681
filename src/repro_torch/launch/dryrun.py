"""Multi-pod dry run: trace every (arch × shape) cell on the production
meshes and extract memory and roofline data, with no card and no memory:
the twin of the JAX package's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape decode_32k --multipod

The reference lowers and compiles each cell on 512 fake CPU devices.  Here
the process is rank 0 of a fake process group of 256 (512) ranks
(``launch.mesh.fake_world``): the parameters, the AdamW state, the batch and
the caches are made on ``meta`` (``build(cfg, device="meta")`` draws
nothing) and distributed as DTensors by ``param_specs``, ``batch_specs`` and
``cache_specs``; the train step, the prefill forward or the decode step then
runs on them under ``roofline.op_counter.OpCounter`` and
``implicit_replication()`` (the plain tensors the models make, such as
positions and masks, count as replicated).  Nothing is computed or
compiled: ``lower_s`` is the trace's wall time, ``compile_s`` is 0.
``memory``: ``argument_bytes`` are rank 0's local shards of every tensor
argument (a Python int, decode's ``pos``, holds no tensor bytes),
``output_bytes`` those of the outputs, ``temp_bytes`` the counter's
high-water mark of what the trace allocated, ``peak_bytes`` their sum with
the arguments.

Depth.  DTensor dispatches op by op from Python, and the chunked attention
of a 32k-token cell issues some 10^5 ops a layer stack, so a cell is traced
at one and at two units of depth (a layer; an xLSTM (mLSTM, sLSTM) pair; a
Zamba2 group; an encoder plus a decoder layer; an MoE model's leading dense
layers kept as they are) and every count is taken linear in depth:
``count(L) = count(1) + (L - 1) (count(2) - count(1))``, the way
``hlo_analyzer`` weights a ``while`` body by its trip count.  DTensor lays
some stacked-layer buffers (a layer slice's gradient) over a mesh dim, and
rank 0 counts an uneven shard's larger part, so deeper traces differ from
the extrapolation by up to a few tenths of a percent in flops and a few
percent in bytes (``tests/test_torch_dryrun.py``).
``argument_bytes`` come from the full-depth state's specs, not from the
extrapolation.

Outputs one JSON per cell under experiments/torch/dryrun/.  A cell that
raises is recorded as ``"error"`` with its exception, and ``main`` returns
1 when any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, all_arch_names, get_config
from ..configs.shapes import SHAPES, ShapeSpec, cell_supported
from ..models.model_zoo import build
from ..roofline.analysis import analyze, model_flops_for
from ..roofline.op_counter import OpCounter
from ..sharding.partition import (P, batch_specs, cache_specs, map_specs, param_specs,
                                  placements, use_mesh)
from ..train.optimizer import AdamWState
from ..train.trainstep import TrainState, make_train_step
from ..tree import tree_leaves, tree_map
from .mesh import fake_world, make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch" / "dryrun"


# --------------------------------------------------------------------------
# depth
# --------------------------------------------------------------------------

def depth_units(cfg: ModelConfig) -> int:
    """The number of repeated units the counts are linear in."""
    if cfg.is_encdec:
        if cfg.n_enc_layers != cfg.n_dec_layers:
            raise ValueError(f"{cfg.name}: depth weighting takes as many encoder as "
                             f"decoder layers, not {cfg.n_enc_layers} and {cfg.n_dec_layers}")
        return cfg.n_enc_layers
    if cfg.family == "ssm":
        return cfg.n_layers // 2
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "moe":
        return cfg.n_layers - cfg.n_dense_layers
    return cfg.n_layers


def at_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` cut to ``units`` repeated units (see :func:`depth_units`)."""
    if cfg.is_encdec:
        return dataclasses.replace(cfg, n_enc_layers=units, n_dec_layers=units)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=2 * units)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every * units)
    if cfg.family == "moe":
        return dataclasses.replace(cfg, n_layers=cfg.n_dense_layers + units)
    return dataclasses.replace(cfg, n_layers=units)


# --------------------------------------------------------------------------
# one traced program
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _place(tree, spec_tree, mesh):
    from torch.distributed.tensor import distribute_tensor

    return map_specs(lambda s, x: distribute_tensor(x, mesh, list(placements(mesh, s))),
                     spec_tree, tree)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _program(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """``(run, args)``: the cell's step and its arguments, as DTensors on
    ``mesh`` made from meta tensors."""
    model = build(cfg, device="meta")
    params = model.init(0)
    pspecs = param_specs(params)
    in_specs = model.input_specs(shape)
    batch = {k: _meta(s.shape, s.dtype) for k, s in in_specs.items()}
    if shape.kind == "decode":
        del batch["pos"]               # the port's decode takes the position as an int
    batch_d = _place(batch, batch_specs(batch, mesh), mesh)

    if shape.kind == "train":
        f32 = tree_map(lambda p: _meta(p.shape, torch.float32), params)
        state = TrainState(params, AdamWState(_meta((), torch.int32), f32,
                                              tree_map(lambda p: _meta(p.shape, p.dtype), f32)))
        sspecs = TrainState(pspecs, AdamWState(P(), pspecs, pspecs))
        state_d = _place(state, sspecs, mesh)
        step = make_train_step(model)
        return (lambda: step(state_d, batch_d)), (state_d, batch_d)
    params_d = _place(params, pspecs, mesh)
    if shape.kind == "prefill":
        def prefill():
            with torch.no_grad():
                logits, _ = model.forward(params_d, batch_d)
            return logits
        return prefill, (params_d, batch_d)
    caches = model.init_caches(None, shape.global_batch, shape.seq_len)
    caches_d = _place(caches, cache_specs(caches, cfg, mesh, shape.global_batch), mesh)
    pos = shape.seq_len // 2

    def decode():
        with torch.no_grad():
            return model.decode_step(params_d, {**batch_d, "pos": pos}, caches_d)
    return decode, (params_d, batch_d, caches_d)


def trace(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Tuple[Dict[str, float], int, int]:
    """``(counter record, argument bytes, output bytes)`` of one traced
    program of ``cfg`` as it is (no depth weighting)."""
    from torch.distributed.tensor.experimental import implicit_replication

    run, args = _program(cfg, shape, mesh)
    with use_mesh(mesh), implicit_replication(), OpCounter(device="meta") as counter:
        out = run()
        out_bytes = _local_bytes(out)
        del out
    return counter.record(), _local_bytes(args), out_bytes


def _extrapolate(r1: Dict[str, float], r2: Dict[str, float], units: int) -> Dict[str, float]:
    return {k: r1[k] + (units - 1) * (r2[k] - r1[k]) for k in r1}


def lower_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
               overrides: Optional[dict] = None, mesh=None) -> Dict[str, Any]:
    """Trace one cell on the production mesh (``mesh`` when given, e.g. a
    small one in tests; either needs a default group with its ranks) and
    return the reference's result dict."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    units = depth_units(cfg)
    t0 = time.perf_counter()
    r1, _, out1 = trace(at_depth(cfg, 1), shape, mesh)
    if units > 1:
        r2, _, out2 = trace(at_depth(cfg, 2), shape, mesh)
        record = _extrapolate(r1, r2, units)
        out_bytes = out1 + (units - 1) * (out2 - out1)
    else:
        record, out_bytes = r1, out1
    t_lower = time.perf_counter() - t0
    arg_bytes = full_argument_bytes(cfg, shape, mesh)

    terms = analyze(record, chips, model_flops_for(cfg, shape))
    temp = int(record["peak_live_bytes"])
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "chips": chips,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": int(out_bytes),
            "temp_bytes": temp,
            "peak_bytes": arg_bytes + temp,
        },
        "roofline": terms.to_dict(),
        "traced_units": [1, 2] if units > 1 else [1],
        "depth_units": units,
        "ops_traced": int(r1["ops"] + (r2["ops"] if units > 1 else 0)),
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {_mesh_tag(mesh)}] trace={t_lower:.1f}s  "
              f"mem(arg={arg_bytes}, temp={temp})  "
              f"terms: C={terms.compute_s:.4f}s M={terms.memory_s:.4f}s "
              f"X={terms.collective_s:.4f}s dom={terms.dominant}", flush=True)
    return result


def full_argument_bytes(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Rank 0's bytes of the full-depth cell's tensor arguments (state or
    parameters, batch, caches), from their specs: nothing is traced."""
    _, args = _program(cfg, shape, mesh)
    return _local_bytes(args)


def _mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in tuple(mesh.shape))


def _run_cells(cells, overrides, opt_tag) -> int:
    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}{opt_tag}"
        out_path = OUT_DIR / f"{tag}.json"
        try:
            result = lower_cell(arch, shape, mp, overrides=overrides)
        except Exception as e:  # noqa: BLE001 -- a cell's failure is its record
            failures += 1
            result = {"arch": arch, "shape": shape, "multi_pod": mp,
                      "status": "error", "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-3000:]}
            print(f"[{tag}] FAILED: {type(e).__name__}: {e}", flush=True)
        out_path.write_text(json.dumps(result, indent=2, default=str))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf knobs), e.g. "
                         "--set seq_parallel=true; result JSON gets an @opt tag")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(v.lower(), v)

    if args.list:
        for a in all_arch_names():
            for s in SHAPES:
                ok, reason = cell_supported(get_config(a), SHAPES[s])
                print(f"{a:24s} {s:12s} {'ok' if ok else reason}")
        return 0

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    archs = all_arch_names() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    opt_tag = ("@" + ",".join(f"{k}={v}" for k, v in sorted(overrides.items()))
               if overrides else "")
    failures = 0
    n_cells = 0
    for mp in meshes:                  # one fake group a mesh size
        cells = [(a, s, mp) for a in archs for s in shapes]
        n_cells += len(cells)
        with fake_world(512 if mp else 256):
            failures += _run_cells(cells, overrides, opt_tag)
    print(f"done: {n_cells} cells, {failures} failures -> {OUT_DIR}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
