"""Rank sides of tests/test_torch_moe_mesh.py: each function runs in one
of the gloo ranks that ``torch_ranks.run_ranks`` spawns, builds the
(pod, data, model) mesh over them and drives the moe kind on it.
Imports torch and the port only, so the ranks start without JAX."""
from __future__ import annotations

from torch_mesh_ranks import _cfg, _engine_tokens, _mesh, _tree

RULES = ("PARAM_RULES", "EP_PARAM_RULES", "NO_FSDP_RULES")


def _rules(name: str):
    from repro_torch.dist import sharding

    if name not in RULES:
        raise ValueError(name)
    return getattr(sharding, name)


def _batch_group(mesh):
    return mesh.group(tuple(a for a in ("pod", "data")
                            if mesh.shape.get(a, 1) > 1))


def block_side(rank: int, n: int, group, shape, cases, w, x, c) -> dict:
    """``moe.moe_block`` on ``shape`` for each case (name, arch, config
    overrides, rule table): the rank's rows of ``x`` (as ``batch_spec``
    splits them) through its blocks of the weights ``w`` (gathered over
    ``data`` as the model's layers gather them), differentiated through
    sum(y * c).  Returns per case the output and every gradient whole
    (x's rows gathered over the batch axes; a weight's gradient summed
    over the batch axes where the weight is not split over ``data``,
    then gathered whole), and this rank's routing (the block's one
    ``moe.route`` call: experts, positions, keep mask, capacity).  On a
    model axis also the all-to-all of ``dist.collectives`` and its
    gradient in f64 (``exchange_check``)."""
    import types

    import torch

    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding
    from repro_torch.models import moe, parallel

    mesh = _mesh(shape)
    out = {"coords": mesh.coords(), "cases": {}}
    bgroup = _batch_group(mesh)
    xspec = sharding.batch_spec(mesh, 3, x.shape[0])
    for name, arch, cfg_kw, rules in cases:
        cfg = _cfg(arch).scaled(**cfg_kw)
        specs = moe.moe_specs(cfg)
        shard = sharding.param_shardings(specs, mesh, _rules(rules))
        local = {k: sharding.shard_tensor(torch.from_numpy(v), shard[k].spec,
                                          mesh).requires_grad_(True)
                 for k, v in w.items()}
        xl = sharding.shard_tensor(torch.from_numpy(x), xspec,
                                   mesh).clone().requires_grad_(True)
        cl = sharding.shard_tensor(torch.from_numpy(c), xspec, mesh)
        routes, route = [], moe.route

        def recording(*a):
            r = route(*a)
            routes.append([t.numpy() if torch.is_tensor(t) else t
                           for t in r[1:]])
            return r

        moe.route = recording
        try:
            m = parallel.gather_layer(types.SimpleNamespace(moe=local),
                                      {"moe": specs}).moe
            y = moe.moe_block(cfg, m, xl)
        finally:
            moe.route = route
        (y * cl).sum().backward()
        grads = {}
        for k, t in local.items():
            g = t.grad
            if "data" not in sharding.spec_axes(shard[k].spec):
                g = coll.all_reduce(g, bgroup)
            grads[k] = sharding.unshard(g, shard[k].spec, mesh).numpy()
        out["cases"][name] = {
            "y": sharding.unshard(y.detach(), xspec, mesh).numpy(),
            "dx": sharding.unshard(xl.grad, xspec, mesh).numpy(),
            "grads": grads, "routes": routes,
            "local_shapes": {k: tuple(t.shape) for k, t in local.items()}}
    if mesh.shape["model"] > 1:
        out["exchange"] = exchange_check(mesh.group("model"),
                                         mesh.coord("model"),
                                         mesh.shape["model"])
    return out


def exchange_check(group, r: int, n: int) -> dict:
    """``coll.all_to_all`` and ``coll.exchange`` on this rank's f64 block
    X_r (n, 3, 5), X_r[j] = 100 r + 10 j + (0 ... 14): Y_r[j] is X_j[r];
    with the loss sum_r <Y_r, W_r>, the gradient of X_r[j] is W_j[r]
    (W_r[j] = 1000 + 100 r + 10 j + ...), exact in f64."""
    import torch

    from repro_torch.dist import collectives as coll

    base = torch.arange(15, dtype=torch.float64).reshape(3, 5)
    x = torch.stack([100 * r + 10 * j + base for j in range(n)])
    wts = torch.stack([1000 + 100 * r + 10 * j + base for j in range(n)])
    plain = coll.all_to_all(x, group)
    xg = x.clone().requires_grad_(True)
    y = coll.exchange(xg, group)
    (y * wts).sum().backward()
    want_y = torch.stack([100 * j + 10 * r + base for j in range(n)])
    want_g = torch.stack([1000 + 100 * j + 10 * r + base for j in range(n)])
    return {"plain": bool(torch.equal(plain, want_y)),
            "y": bool(torch.equal(y.detach(), want_y)),
            "grad": bool(torch.equal(xg.grad, want_g)),
            "dtype": str(y.dtype)}


def serve_side(rank: int, n: int, group, shape, arch: str, cfg_kw, params,
               prompts, n_gen: int, requests) -> dict:
    """The moe model on ``shape`` with the reference's weights cut under
    SERVE_RESIDENT_RULES (``cfg_kw`` may turn on ``moe_ep``: the experts
    are resharded at use): the f32 engine's tokens at full occupancy,
    each prompt its own prefill call, and ``launch.serve.drive``'s over
    ``requests``."""
    from repro_torch.dist import meshctx, sharding
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry, transformer
    from repro_torch.serve import ServeEngine

    mesh = _mesh(shape)
    cfg = _cfg(arch).scaled(**cfg_kw)
    shard = sharding.param_shardings(registry.param_specs(cfg), mesh,
                                     sharding.SERVE_RESIDENT_RULES)
    model = transformer.Transformer(
        cfg, sharding.shard_tree(_tree(params), shard))
    engine = ServeEngine(cfg, max_slots=prompts.shape[0],
                         max_prefill_len=prompts.shape[1], max_gen_len=n_gen,
                         device="cpu")
    toks = _engine_tokens(engine, model, prompts, n_gen)
    outputs, _ = launch.drive(
        ServeEngine(cfg, max_slots=2, max_prefill_len=prompts.shape[1],
                    max_gen_len=n_gen, device="cpu"), model, requests)
    return {"engine": toks, "drive": outputs,
            "w_gate": tuple(model.layers[0].moe["w_gate"].shape),
            "mesh": meshctx.get_mesh().shape}


def jobs_side(rank: int, n: int, group, jobs) -> list:
    """Several rank sides in one process group, in order: each (module,
    function name, args) called as ``fn(rank, n, group, *args)``; their
    results in a list.  Every rank makes the same meshes in the same
    order, as ``meshctx.make_mesh`` requires."""
    import importlib

    return [getattr(importlib.import_module(mod), fn)(rank, n, group, *args)
            for mod, fn, args in jobs]
