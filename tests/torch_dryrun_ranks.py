"""Rank sides of tests/test_torch_dryrun.py: a dry-run step of a smoke cell
(``launch.dryrun.build_step``) run for real in each gloo rank on the CPU,
its inputs the rank's blocks, with every ``torch.distributed`` call that
``dist.collectives`` makes counted at the boundary: its kind and the bytes
of its result buffer.  Imports torch and the port only."""
from __future__ import annotations

from torch_mesh_ranks import _mesh


def smoke_cfg(arch: str, cfg_kw: dict):
    from repro_torch import configs

    return configs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                 **cfg_kw)


def count_side(rank: int, n: int, group, shape, arch: str, cfg_kw, sh,
               compress: str, opts) -> dict:
    """The counts and bytes, by kind, of the collectives rank ``rank``
    issues in one step of the cell."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as coll
    from repro_torch.launch import dryrun

    mesh = _mesh(shape)
    cfg = smoke_cfg(arch, cfg_kw)
    fn, args, shardings = dryrun.build_step(cfg, sh, mesh, compress, opts)
    local = dryrun.place(args, shardings, "cpu", dryrun.ROLES[sh["step"]],
                         cfg, seed=rank)
    rec = coll.new_record()

    def counted(kind, call, out_arg):
        def wrapped(*a, **kw):
            out = a[out_arg]
            rec["counts"][kind] += 1
            rec["bytes"][kind] += out.numel() * out.element_size()
            return call(*a, **kw)
        return wrapped

    saved = (dist.all_reduce, coll._all_gather_single,
             coll._reduce_scatter_single, dist.all_to_all_single)
    dist.all_reduce = counted("all-reduce", saved[0], 0)
    coll._all_gather_single = counted("all-gather", saved[1], 0)
    coll._reduce_scatter_single = counted("reduce-scatter", saved[2], 0)
    dist.all_to_all_single = counted("all-to-all", saved[3], 0)
    try:
        out = dryrun._run(fn, local, sh["step"] == "train")
    finally:
        (dist.all_reduce, coll._all_gather_single,
         coll._reduce_scatter_single, dist.all_to_all_single) = saved
    finite = all(bool(torch.isfinite(t).all()) for t in dryrun._leaves(out)
                 if t.is_floating_point())
    return {"record": rec, "finite": finite}
