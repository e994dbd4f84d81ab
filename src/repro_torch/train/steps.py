"""Step builders (the port of ``repro.train.steps``): the train step with
microbatching (gradient accumulation), mixed precision, remat, and the
paper's compressed aggregation of the gradients; the prefill and serve
steps; and the mesh placement of a train state.

A train state is ``{"params", "opt_state", "step"}`` in the JAX
package's structure: the parameter tree in its layout (layer stacks on
a leading axis), the optimizer's state (AdamW ``(m, v, count)``) and an
int32 step, so a checkpoint reads the same in both packages.  On a mesh
each rank holds its block of every leaf under ``train_state_shardings``
(``PARAM_RULES``; ``EP_PARAM_RULES`` for a moe config with ``moe_ep``;
``NO_FSDP_RULES`` for a compressed step over a ``pod`` axis), the
optimizer's leaves as their parameter.

``build_train_step(cfg, tc, group=None, mesh=None)`` returns
``step(state, batch, seed) -> (state, metrics)``:

  * on one rank (no mesh, or a mesh of one): the loss and gradient of the
    whole batch, then, with compression, the n = 1 point-to-point
    mechanism (``compress_tree(axis=None)``, quantization plus exact
    noise) under ``fold_in(PRNGKey(seed), step)``;
  * with compression and a ``pod`` axis (``group=``, a process group of
    the client ranks, is the mesh of pods alone): each pod is one client,
    and the global batch splits over (pod, data).  Each rank differentiates
    its rows on its tensor-parallel blocks; the pod's gradient is
    averaged over ``data`` and gathered to whole leaves over ``model``, as
    the reference's ``shard_map`` with ``in_specs=P("pod")`` hands every
    device whole leaves, so the messages are the one-process codec's; then
    ``compress_tree(axis=<pod group>)`` sums them across pods and each rank
    keeps its block of the update;
  * otherwise: the global mean gradient over the batch axes (FSDP's
    reduce-scatter over ``data`` in the backward of each gather, an
    all-reduce of the rest), then, with compression, the n = 1 mechanism
    on whole leaves.

The loss is differentiated by autograd through the model on the compute
copy of the params (``nn.cast_tree``: the cast comes before any gather,
so FSDP moves the compute dtype), whose attention runs the flash kernels
forward and backward on the card.  ``TrainConfig.gather_once`` gathers
the compute copy over ``data`` once per step instead of at each layer's
use, and reduce-scatters its gradient once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.core import prng
from repro_torch.dist import collectives as coll
from repro_torch.dist import compress as compress_mod
from repro_torch.dist import meshctx, sharding
from repro_torch.models import nn, registry
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.optim.optimizers import get_optimizer, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    grad_accum: int = 1
    compression: Optional[compress_mod.CompressionConfig] = None
    gather_once: bool = False  # ZeRO-1-style: gather the compute copy
    #   over 'data' ONCE per step instead of at each layer's use


# ------------------------------------------------------------- inputs
def input_specs(cfg: ModelConfig, shape_name) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of a cell (a
    ``configs.SHAPES`` name, or such an entry itself)."""
    sh = (configs.SHAPES[shape_name] if isinstance(shape_name, str)
          else shape_name)
    B, T = sh["global_batch"], sh["seq_len"]
    dt = torch_dtype(cfg.compute_dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if sh["step"] == "decode":
        return {"tokens": meta((B, 1), torch.int32)}
    specs = {"tokens": meta((B, T), torch.int32)}
    if cfg.kind == "whisper":
        specs["frames"] = meta((B, cfg.encoder_len, cfg.d_model), dt)
    if cfg.kind == "llava":
        specs["tokens"] = meta((B, T - cfg.n_patches), torch.int32)
        specs["patches"] = meta((B, cfg.n_patches, cfg.d_model), dt)
    return specs


def batch_shardings(cfg: ModelConfig, shape_name, mesh):
    return {k: sharding.NamedSharding(
        mesh, sharding.batch_spec(mesh, v.dim(), v.shape[0]))
        for k, v in input_specs(cfg, shape_name).items()}


# ------------------------------------------------------------- train
def make_train_state_specs(cfg: ModelConfig, tc: TrainConfig):
    """The {params, opt_state, step} tree as meta tensors (shapes and
    dtypes, nothing allocated): the structure a restore fills."""
    params = nn.abstract_params(registry.param_specs(cfg))
    opt = get_optimizer(tc.optimizer, tc.lr)
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_rules(cfg: ModelConfig, tc: TrainConfig, mesh) -> sharding.Rules:
    """The rule table of a train state on ``mesh``: PARAM_RULES (EP for a
    moe config that asks for it); NO_FSDP_RULES for a compressed step
    over a ``pod`` axis, so each pod's gradient leaves are whole along
    the summed dimension."""
    rules = sharding.PARAM_RULES
    if getattr(cfg, "moe_ep", False):
        rules = sharding.EP_PARAM_RULES
    if tc.compression is not None and "pod" in mesh.axis_names:
        rules = sharding.NO_FSDP_RULES
    return rules


def train_state_shardings(cfg: ModelConfig, tc: TrainConfig, mesh):
    """NamedShardings of {params, opt_state, step}: each optimizer tree
    (AdamW's m and v) mirrors the parameters, leaf by leaf, and scalars
    are replicated.  (The reference mirrors by shape, the first parameter
    of a shape giving every leaf of that shape its placement, which
    GSPMD reshards where two leaves of one shape differ; here the
    optimizer's update is elementwise on each rank's block, so each leaf
    takes its own parameter's.)"""
    pshard = sharding.param_shardings(registry.param_specs(cfg), mesh,
                                      state_rules(cfg, tc, mesh))
    rep = sharding.NamedSharding(mesh, sharding.P())
    opt_like = make_train_state_specs(cfg, tc)["opt_state"]
    opt_shard = type(opt_like)(pshard if isinstance(t, dict) else rep
                               for t in opt_like)
    return {"params": pshard, "opt_state": opt_shard, "step": rep}


def _on_mesh(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
                     device=None, mesh=None):
    """A fresh state on ``device`` (CUDA unless "cpu"): the params from
    the port's own init (``nn.init_params`` under a torch generator seeded
    with ``seed``; jax.random's numbers differ, so tests carry the JAX
    package's params across instead).  On a mesh each leaf is drawn whole,
    in the same order, and cut to this rank's block at once."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    specs = registry.param_specs(cfg)
    if _on_mesh(mesh):
        pshard = train_state_shardings(cfg, tc, mesh)["params"]

        def draw(path, spec):
            ns = functools.reduce(lambda node, k: node[k], path, pshard)
            return sharding.shard_tensor(nn.init_leaf(spec, gen, dev),
                                         ns.spec, mesh)

        params = nn.map_specs(draw, specs)
    else:
        params = nn.init_params(specs, gen, dev)
    opt = get_optimizer(tc.optimizer, tc.lr)
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def restore_train_state(directory: str, cfg: ModelConfig, tc: TrainConfig,
                        step: Optional[int] = None, device=None, mesh=None):
    """Elastic restore of a train state written by either package onto
    ``device`` and, on a mesh, each rank's block of it: placement is
    re-resolved through the rule tables for the *target* mesh, so a
    checkpoint written on one mesh restores onto another.  Returns
    ``(state, step)``; raises if no committed checkpoint exists."""
    from repro_torch.checkpoint import checkpoint

    if step is None:
        step = checkpoint.latest_step(directory)
        if step is None:
            raise checkpoint.CheckpointError(
                f"no committed checkpoint under {directory}")
    like = make_train_state_specs(cfg, tc)
    shardings = (train_state_shardings(cfg, tc, mesh) if _on_mesh(mesh)
                 else None)
    return checkpoint.restore(directory, step, like, device=device,
                              shardings=shardings), step


def _split_microbatches(batch: Dict, accum: int) -> list:
    """``accum`` microbatches of ``B / accum`` rows each, in order."""
    out = []
    for i in range(accum):
        mb = {}
        for k, v in batch.items():
            n = v.shape[0] // accum
            mb[k] = v[i * n:(i + 1) * n]
        out.append(mb)
    return out


def _client_slice(batch: Dict, rank: int, n: int) -> Dict:
    """Client ``rank``'s rows of the global batch (the JAX package's
    reshape to (n_clients, B / n, ...))."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"global batch {v.shape[0]} does not split "
                             f"over {n} clients")
        b = v.shape[0] // n
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def value_and_grad(cfg: ModelConfig, params, batch):
    """(loss, gradient tree in f32) of the NLL on ``batch``, through the
    compute copy of ``params`` (cast to ``cfg.compute_dtype``).  A leaf
    the loss does not use (zamba2's Mamba2 ``norm_w``, which the
    reference's block never reads) has a zero gradient, as in
    ``jax.grad``."""
    leaves, rebuild = compress_mod._flatten(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    loss = registry.loss_fn(cfg)(
        nn.cast_tree(rebuild(req), torch_dtype(cfg.compute_dtype)), batch)
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    return loss.detach(), rebuild([
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if g is None else g.to(torch.float32) for g, p in zip(grads, req)])


def loss_and_grads(cfg: ModelConfig, tc: TrainConfig, params, batch):
    """The JAX step's ``grads_of``: the batch's loss and gradient, over
    ``tc.grad_accum`` microbatches in order (summed from f32 zeros, then
    scaled by 1 / accum)."""
    if tc.grad_accum <= 1:
        return value_and_grad(cfg, params, batch)
    loss_acc = None
    g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for mb in _split_microbatches(batch, tc.grad_accum):
        l, g = value_and_grad(cfg, params, mb)
        loss_acc = l if loss_acc is None else loss_acc + l
        g_acc = tree_map(torch.add, g_acc, g)
        del g
    inv = 1.0 / tc.grad_accum
    return loss_acc * inv, tree_map(lambda x: x * inv, g_acc)


def _rank_rows(batch: Dict, mesh, placed: bool = False) -> Dict:
    """This rank's rows of the global batch: its block along the batch
    axes (``batch_spec``; the reference's reshape to (pod, B / pod) and
    GSPMD's split of each client's rows over ``data``); the batch itself
    when it is ``placed`` (each rank given its block already)."""
    if placed:
        return batch
    return {k: sharding.shard_tensor(
        v, sharding.batch_spec(mesh, v.dim(), v.shape[0]), mesh)
        for k, v in batch.items()}


def _batch_group(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return mesh.group(axes), mesh.axis_size(axes)


def mesh_loss_and_grads(cfg: ModelConfig, tc: TrainConfig, mesh, params,
                        batch, shardings, placed: bool = False):
    """The global mean loss and gradient on a mesh, each rank's block of
    it: its rows differentiated on its blocks (FSDP's gathers
    reduce-scatter their gradients over ``data``), the rest summed over
    the batch axes, then divided by their size.  ``shardings``: the
    params' NamedSharding tree; ``placed``: ``batch`` is the rank's rows
    already."""
    local = _rank_rows(batch, mesh, placed)
    leaves, rebuild = compress_mod._flatten(params)
    specs = [ns.spec for ns in sharding.tree_leaves(shardings)]
    if tc.gather_once and mesh.shape.get("data", 1) > 1:
        dt = torch_dtype(cfg.compute_dtype)
        with torch.no_grad():
            whole = rebuild([sharding.unshard(nn.cast_tree(p, dt), sp, mesh,
                                              axes=("data",))
                             for p, sp in zip(leaves, specs)])
        loss, g = loss_and_grads(cfg, tc, whole, local)
        del whole
        g = [sharding.reduce_scatter(x, sp, mesh, axes=("data",))
             for x, sp in zip(compress_mod._flatten(g)[0], specs)]
    else:
        loss, g = loss_and_grads(cfg, tc, params, local)
        g = compress_mod._flatten(g)[0]
    group, n = _batch_group(mesh)
    pod = mesh.group("pod") if "pod" in mesh.axis_names else None
    inv = 1.0 / n
    out = []
    for x, sp in zip(g, specs):
        # a leaf held in part over data was summed over it in the backward
        x = coll.all_reduce(x, pod if "data" in sharding.spec_axes(sp)
                            else group)
        out.append(x * inv)
    return coll.all_reduce(loss, group) * inv, rebuild(out)


def build_train_step(cfg: ModelConfig, tc: TrainConfig, group=None,
                     mesh=None, placed: bool = False):
    """Returns step(state, batch, seed) -> (state, metrics{loss, cohort}).

    ``group``: a process group of the client ranks, each holding the
    whole model (a mesh of pods alone; it needs ``tc.compression``).
    ``mesh``: a ``meshctx.Mesh`` whose ranks hold the state's blocks
    (``train_state_shardings``); with ``placed`` each rank is given its
    rows of the batch (its block under ``batch_shardings``, as the dry
    run places its inputs) instead of the global batch.  See the module's
    docstring for the branches."""
    opt = get_optimizer(tc.optimizer, tc.lr)
    comp = tc.compression
    if group is not None and mesh is not None:
        raise ValueError("give a client group or a mesh, not both")
    if group is not None and not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"group must be a torch.distributed ProcessGroup "
                        f"of the client ranks, got {group!r}")
    if group is not None and comp is None:
        raise ValueError("the step across client ranks aggregates through "
                         "compress_tree: give TrainConfig a compression")
    n_clients = 1 if group is None else dist.get_world_size(group)

    def grads_of(params, batch):
        return loss_and_grads(cfg, tc, params, batch)

    def apply_update(state, grads, loss, cohort):
        params, opt_state = opt.apply(grads, state["opt_state"],
                                      state["params"])
        return ({"params": params, "opt_state": opt_state,
                 "step": state["step"] + 1},
                {"loss": loss, "cohort": cohort})

    def key_of(state, seed):
        # a meta step (the dry run) has no value to read: its draws are
        # shapes alone, so any key serves
        step = state["step"]
        return prng.fold_in(prng.PRNGKey(int(seed)),
                            0 if step.is_meta else int(step))

    if _on_mesh(mesh):
        return _mesh_step(cfg, tc, mesh, apply_update, key_of, placed)

    if group is not None:
        rank = dist.get_rank(group)

        def step(state, batch, seed):
            device = state["step"].device
            loss, grads = grads_of(state["params"],
                                   _client_slice(batch, rank, n_clients))
            grads = compress_mod.compress_tree(
                grads, comp, key_of(state, seed), axis=group,
                n_clients=n_clients, device=device)
            losses = loss.reshape(1).to(torch.float32).clone()
            dist.all_reduce(losses, op=dist.ReduceOp.SUM, group=group)
            return apply_update(state, grads, losses[0] / n_clients,
                                n_clients)

        return step

    def step(state, batch, seed):
        loss, grads = grads_of(state["params"], batch)
        if comp is not None:  # n = 1 point-to-point exact-noise quantization
            grads = compress_mod.compress_tree(
                grads, comp, key_of(state, seed), axis=None, n_clients=1,
                device=state["step"].device)
        return apply_update(state, grads, loss, n_clients)

    return step


def _mesh_step(cfg: ModelConfig, tc: TrainConfig, mesh, apply_update,
               key_of, placed: bool = False):
    """The step on a mesh of more than one rank."""
    comp = tc.compression
    shardings = train_state_shardings(cfg, tc, mesh)["params"]
    specs = [ns.spec for ns in sharding.tree_leaves(shardings)]
    has_pod = "pod" in mesh.axis_names
    n_pod = mesh.shape["pod"] if has_pod else 1

    def whole(tree):  # every leaf gathered from the ranks' blocks
        leaves, rebuild = compress_mod._flatten(tree)
        return rebuild([sharding.unshard(x, sp, mesh)
                        for x, sp in zip(leaves, specs)])

    def block(tree):
        leaves, rebuild = compress_mod._flatten(tree)
        return rebuild([sharding.shard_tensor(x, sp, mesh)
                        for x, sp in zip(leaves, specs)])

    if comp is not None and has_pod:
        pod = mesh.group("pod")
        data = mesh.group("data") if "data" in mesh.axis_names else None
        n_data = mesh.shape.get("data", 1)
        group, n = _batch_group(mesh)

        def step(state, batch, seed):
            device = state["step"].device
            with meshctx.use_mesh(mesh):
                loss, grads = loss_and_grads(cfg, tc, state["params"],
                                             _rank_rows(batch, mesh, placed))
                if n_data > 1:  # the pod's mean over its data ranks
                    grads = tree_map(
                        lambda g: coll.all_reduce(g, data) * (1.0 / n_data),
                        grads)
                # each pod is one client holding whole leaves
                agg = compress_mod.compress_tree(
                    whole(grads), comp, key_of(state, seed), axis=pod,
                    n_clients=n_pod, device=device)
                del grads
                realized = coll.all_reduce(
                    torch.ones((), dtype=torch.int32, device=device), pod)
                # a meta count (the dry run's recording group) is the
                # group's size, which it stands for; a real one is read
                realized = (coll.size(pod) if realized.is_meta
                            else int(realized))
                loss = coll.all_reduce(loss.to(torch.float32), group) / n
            return apply_update(state, block(agg), loss, realized)

        return step

    def step(state, batch, seed):
        with meshctx.use_mesh(mesh):
            loss, grads = mesh_loss_and_grads(cfg, tc, mesh, state["params"],
                                              batch, shardings, placed)
            if comp is not None:  # the n = 1 mechanism on whole leaves
                grads = block(compress_mod.compress_tree(
                    whole(grads), comp, key_of(state, seed), axis=None,
                    n_clients=1, device=state["step"].device))
        return apply_update(state, grads, loss, n_pod)

    return step


# ------------------------------------------------------------- serving
def build_prefill_step(cfg: ModelConfig):
    """prefill(model, batch) -> (last-position logits, caches); ``model``
    a model or a parameter tree (seen through ``registry.tree_model``)."""
    fn = registry.prefill_fn(cfg)

    def prefill(model, batch):
        return fn(registry.tree_model(cfg, model), batch)

    return prefill


def build_serve_step(cfg: ModelConfig, cache_shardings=None):
    """serve(model, batch, cache) -> (logits, new kv or state); ``model``
    a model or a parameter tree.  ``cache_shardings``: the placement of
    the cache whose blocks each rank is given
    (``registry.decode_state_shardings``): where it splits the K / V
    sequence over ``model``, each rank decodes against its rows and the
    softmax is combined across the axis (``registry.serve_fn(seq=)``)."""
    fn = registry.serve_fn(cfg)
    split = None
    if cache_shardings is not None and "k" in cache_shardings:
        ns = cache_shardings["k"]
        if len(ns.spec) > 2 and ns.spec[2] == "model":
            split = ns.mesh

    def serve(model, batch, cache):
        seq = None
        if split is not None:
            seq = (split.group("model"),
                   split.coord("model") * cache["k"].shape[2])
        return fn(registry.tree_model(cfg, model), batch, cache, seq=seq)

    return serve
