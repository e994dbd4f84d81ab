"""The train step (the port of ``repro.train.steps``, training half):
microbatching (gradient accumulation), mixed precision, remat, and the
paper's compressed aggregation of the gradients.

A train state is ``{"params", "opt_state", "step"}`` in the JAX
package's structure: the parameter tree in its layout (layer stacks on
a leading axis), the optimizer's state (AdamW ``(m, v, count)``) and an
int32 step, so a checkpoint reads the same in both packages.

``build_train_step(cfg, tc, group=None)`` returns ``step(state, batch,
seed) -> (state, metrics)``:

  * without ``group`` (the JAX package's mesh without a ``pod`` axis):
    the loss and gradient of the whole batch, then, with compression,
    the n = 1 point-to-point mechanism (``compress_tree(axis=None)``,
    quantization plus exact noise) under ``fold_in(PRNGKey(seed),
    step)``;
  * with ``group``, a ``torch.distributed`` process group whose ranks
    are the clients (the JAX package's ``pod`` axis): each rank takes
    its ``B / n`` slice of the global batch, computes its gradient, and
    the gradients are aggregated by ``compress_tree(axis=group)``, the
    integer sum across ranks; every rank applies the same update.

The loss is differentiated by autograd through the model on the compute
copy of the params (``nn.cast_tree``), whose attention runs the flash
kernels forward and backward on the card.  The JAX package's
``make_train_state_specs`` abstract tree becomes meta tensors here; its
``train_state_shardings``, ``batch_shardings`` and ``gather_once`` map
the state onto a TPU mesh and have no counterpart on one card (see the
README).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import prng
from repro_torch.dist import compress as compress_mod
from repro_torch.models import nn, registry
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.optim.optimizers import get_optimizer, tree_map

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"
    lr: float = 3e-4
    grad_accum: int = 1
    compression: Optional[compress_mod.CompressionConfig] = None


def make_train_state_specs(cfg: ModelConfig, tc: TrainConfig):
    """The {params, opt_state, step} tree as meta tensors (shapes and
    dtypes, nothing allocated): the structure a restore fills."""
    params = nn.map_specs(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        registry.param_specs(cfg))
    opt = get_optimizer(tc.optimizer, tc.lr)
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
                     device=None):
    """A fresh state on ``device`` (CUDA unless "cpu"): the params from
    the port's own init (``nn.init_params`` under a torch generator seeded
    with ``seed``; jax.random's numbers differ, so tests carry the JAX
    package's params across instead)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = nn.init_params(registry.param_specs(cfg), gen, dev)
    opt = get_optimizer(tc.optimizer, tc.lr)
    return {"params": params, "opt_state": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def restore_train_state(directory: str, cfg: ModelConfig, tc: TrainConfig,
                        step: Optional[int] = None, device=None):
    """Restore a train state written by either package onto ``device``:
    ``(state, step)``.  Raises if no committed checkpoint exists.  The JAX
    package re-resolves leaf placement for its target mesh; on one card
    every leaf lands on the device."""
    from repro_torch.checkpoint import checkpoint

    if step is None:
        step = checkpoint.latest_step(directory)
        if step is None:
            raise checkpoint.CheckpointError(
                f"no committed checkpoint under {directory}")
    like = make_train_state_specs(cfg, tc)
    return checkpoint.restore(directory, step, like, device=device), step


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


def build_train_step(cfg: ModelConfig, tc: TrainConfig, group=None):
    """Returns step(state, batch, seed) -> (state, metrics{loss, cohort}).

    With ``group`` (a process group of the client ranks; it needs
    ``tc.compression``) per-client gradients are aggregated by the AINQ
    mechanism across the ranks.  Without ``group`` the gradient is the
    batch's, and with compression the n = 1 point-to-point mechanism
    still applies exact noise."""
    opt = get_optimizer(tc.optimizer, tc.lr)
    comp = tc.compression
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
        return prng.fold_in(prng.PRNGKey(int(seed)), int(state["step"]))

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
