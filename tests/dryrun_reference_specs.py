"""The reference's dry-run placements, for tests/test_torch_dryrun.py: run as
its own process (``repro.launch.dryrun`` sets XLA_FLAGS for 512 host
devices when imported, which must not reach the pytest process).  For
every cell of ``configs.cells()`` on both production meshes it prints one
JSON object: per cell, the PartitionSpec and global shape of every leaf of
``build_cell``'s inputs, in pytree order, and the param and opt-state
counts of a train cell.

  PYTHONPATH=src python tests/dryrun_reference_specs.py
"""
import json
import sys


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return list(e)


def main():
    from repro.launch import dryrun  # sets XLA_FLAGS before jax loads

    import jax
    from jax.sharding import NamedSharding

    from repro import configs
    from repro.launch.mesh import make_production_mesh

    out = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, shape, _ in configs.cells():
            _, args, shardings = dryrun.build_cell(arch, shape, mesh)
            specs = jax.tree.leaves(
                shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
            leaves = [x for x in jax.tree.leaves(args) if hasattr(x, "shape")]
            rec = {"specs": [[_entry(e) for e in s.spec] for s in specs],
                   "shapes": [list(x.shape) for x in leaves]}
            if configs.SHAPES[shape]["step"] == "train":
                rec["n_params"] = len(jax.tree.leaves(args[0]["params"]))
                rec["n_opt"] = len(jax.tree.leaves(args[0]["opt_state"]))
            out[f"{arch}|{shape}|{int(multi_pod)}"] = rec
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
