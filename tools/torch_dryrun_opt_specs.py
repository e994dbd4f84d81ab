"""Where the dry run's train state is placed otherwise than the reference's:
per train cell of ``configs.cells()`` on (16, 16) and (2, 16, 16), the
optimizer leaves whose spec differs from the reference's, and rank 0's
optimizer bytes under each placement.

The reference mirrors each optimizer leaf on the first parameter of its
shape; the port gives each leaf its own parameter's spec
(``steps.train_state_shardings``).  The reference's specs come from its
own ``build_cell``, in a process of its own with 512 host devices
(tests/dryrun_reference_specs.py).

Usage: PYTHONPATH=src python tools/torch_dryrun_opt_specs.py
"""
import json
import math
import os
import subprocess
import sys

import torch

from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_specs() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    got = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "dryrun_reference_specs.py")],
        capture_output=True, text=True, env=env, check=True)
    return json.loads(got.stdout)


def _norm(spec):
    out = [tuple(e) if isinstance(e, list) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _sorted_leaves(tree):
    """Leaves in the reference's pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _rank_bytes(t: torch.Tensor, spec, mesh) -> int:
    shape = sharding.shard_shape(t.shape, sharding.P(*spec), mesh)
    return math.prod(shape) * t.element_size()


def main() -> None:
    ref = reference_specs()
    print("| arch | mesh | optimizer leaves | spec differs | rank 0's "
          "optimizer MiB, reference's placement | port's | port - "
          "reference MiB |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
        name = "2x16x16" if multi_pod else "16x16"
        for arch, shape in configs.cells():
            if configs.SHAPES[shape]["step"] != "train":
                continue
            want = ref[f"{arch}|{shape}|{int(multi_pod)}"]
            _, args, shardings = dryrun.build_cell(arch, shape, mesh)
            port = [_norm(ns.spec) for ns in sharding.tree_leaves(shardings)]
            leaves = _sorted_leaves(args)
            n_opt = want["n_opt"]
            differ, b_ref, b_port = 0, 0, 0
            for i in range(n_opt):
                theirs = _norm(want["specs"][i])
                differ += theirs != port[i]
                b_ref += _rank_bytes(leaves[i], theirs, mesh)
                b_port += _rank_bytes(leaves[i], port[i], mesh)
            print(f"| {arch} | {name} | {n_opt} | {differ} | "
                  f"{b_ref / 2**20:.3f} | {b_port / 2**20:.3f} | "
                  f"{(b_port - b_ref) / 2**20:+.3f} |")


if __name__ == "__main__":
    main()
