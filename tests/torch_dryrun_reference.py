"""Runs the JAX package's dry run on a 2x2 mesh of CPU devices and prints
one JSON line of results: the reference side of ``test_torch_dryrun.py``.

    python tests/torch_dryrun_reference.py '<json list of [arch, shape, overrides]>'

Run in a process of its own: the reference's ``launch/dryrun.py`` sets
``XLA_FLAGS`` to 512 host devices before JAX starts, and its
``make_production_mesh`` is replaced here, in this process only, by
``make_host_mesh(2, 2)``.
"""
import json
import sys


def main(cells) -> None:
    from repro.launch import dryrun
    from repro.launch.mesh import make_host_mesh

    dryrun.make_production_mesh = lambda multi_pod=False: make_host_mesh(2, 2)
    out = []
    for arch, shape, overrides in cells:
        r = dryrun.lower_cell(arch, shape, False, verbose=False, overrides=overrides)
        out.append({"arch": arch, "shape": shape, "status": r["status"],
                    "chips": r["chips"], "memory": r["memory"],
                    "roofline": {k: r["roofline"][k] for k in
                                 ("model_flops", "flops_per_device", "bytes_per_device",
                                  "collective_bytes_per_device", "collectives")}})
    print(json.dumps(out))


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
