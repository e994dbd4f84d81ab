"""Zamba2 hybrid: a Mamba2 backbone and one *shared* attention + MLP
block applied every ``shared_attn_every`` layers (one set of weights at
every application); the port of ``repro.models.zamba2``.

Layout for n_layers = G * every + tail: G groups of (every - 1 Mamba2
layers, then the shared block), then ``tail`` Mamba2 layers (zamba2-7b:
13 groups of 5 and a tail of 3).  The shared block's attention has a
sliding window (``cfg.window``, 4096): on the scan path it runs the flash
kernels with the window (``attention.flash_attention``), forward and
backward; in decode each group's application has its own KV ring of W
rows (the weights are shared, the activations are not), row ``pos % W``
holding position ``pos``'s RoPE-rotated K and V, ``kv_pos`` each row's
position (-1 empty), so that ``decode_attention`` masks emptiness and the
window without reordering the ring.

``Zamba2`` holds the parameters under the reference's names: ``groups``
(G lists of ``Mamba2Layer``), ``shared_attn`` (a
``transformer.DecoderLayer``: ``attn``, ``mlp``, ``norm1_w``,
``norm2_w``), ``tail``, ``embed``, ``final_w``, ``lm_head``.
``TreeModel`` views a parameter tree in the reference's layout (stacks
(G, every - 1, ...) and (tail, ...)) the same way, each layer's slices
unbound from the stacks; the shared block's leaves are used at every
group, so their gradient sums over the applications.  ``cfg.remat``
other than ``none`` recomputes each Mamba2 layer and each application of
the shared block in the backward (``torch.utils.checkpoint``), as the
reference's nested ``jax.checkpoint`` does.

On the mesh each Mamba2 layer and the shared block are gathered over
``data`` where held in part; over ``model`` the Mamba2 layers run as
``models.mamba2`` says, the shared block through the transformer's
tensor-parallel attention and MLP, the embedding vocab-parallel and the
logits the rank's vocab block.  The decode state holds the rank's heads
of the SSD states and KV rings (``registry.decode_state_shardings``).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Tuple

import torch
from torch import nn as tnn
from torch.utils import checkpoint

from repro_torch import resolve_device
from repro_torch.models import mamba2, nn, parallel, transformer
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.nn import ParamSpec


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind != "zamba2":
        raise ValueError(f"kind={cfg.kind!r} is not zamba2")


def layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(groups, Mamba2 layers a group, tail Mamba2 layers)."""
    every = cfg.shared_attn_every
    groups = cfg.n_layers // every
    return groups, every - 1, cfg.n_layers - groups * every


# ----------------------------------------------------------------- specs
def _stack(spec: ParamSpec, dims, names) -> ParamSpec:
    return ParamSpec(tuple(dims) + spec.shape, tuple(names) + spec.axes,
                     spec.init, spec.scale, spec.dtype)


def mamba_layer_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {**mamba2.mamba2_specs(cfg),
            "norm_in": ParamSpec((cfg.d_model,), ("embed",), "ones")}


def shared_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "attn": transformer.attn_specs(cfg),
        "mlp": transformer.mlp_specs(cfg),
        "norm1_w": ParamSpec((cfg.d_model,), ("embed",), "ones"),
        "norm2_w": ParamSpec((cfg.d_model,), ("embed",), "ones"),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_kind(cfg)
    groups, per_group, tail = layout(cfg)
    m_spec = mamba_layer_specs(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab_in", "embed"), "embed"),
        "groups": nn.map_specs(
            lambda _, s: _stack(s, (groups, per_group),
                                ("layers", "layers_inner")), m_spec),
        "shared_attn": shared_specs(cfg),
        "final_w": ParamSpec((cfg.d_model,), ("embed",), "ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab")),
    }
    if tail:
        specs["tail"] = nn.map_specs(
            lambda _, s: _stack(s, (tail,), ("layers",)), m_spec)
    return specs


# --------------------------------------------------------------- modules
class Mamba2Layer(tnn.Module):
    """One Mamba2 layer's parameters under the reference's names."""

    def __init__(self, tree: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tree.items():
            setattr(self, name, tnn.Parameter(t, requires_grad=False))


def _split_stacks(cfg: ModelConfig, tree: Dict[str, Any]):
    """(groups, tail) of a tree in the reference's layout: lists of
    per-layer dicts of the stacks' slices (``unbind``, whose backward
    stacks the layers' gradients)."""
    G, pg, tail = layout(cfg)
    groups: List[List[Dict[str, Any]]] = [[{} for _ in range(pg)]
                                          for _ in range(G)]
    for name, t in tree["groups"].items():
        if tuple(t.shape[:2]) != (G, pg):
            raise ValueError(f"group stack {name} of {tuple(t.shape[:2])}, "
                             f"expected {(G, pg)}")
        for g, row in enumerate(t.unbind(0)):
            for i, leaf in enumerate(row.unbind(0)):
                groups[g][i][name] = leaf
    tails: List[Dict[str, Any]] = [{} for _ in range(tail)]
    for name, t in tree.get("tail", {}).items():
        if t.shape[0] != tail:
            raise ValueError(f"tail stack {name} of {t.shape[0]}, "
                             f"expected {tail}")
        for i, leaf in enumerate(t.unbind(0)):
            tails[i][name] = leaf
    return groups, tails


class Zamba2(tnn.Module):
    """The model, built from a parameter tree in the reference's layout
    (each layer's slice is copied out of its stack), or with
    ``tree["groups"]`` a list of G lists of per-layer trees and
    ``tree["tail"]`` a list of per-layer trees, taken as they are."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        _check_kind(cfg)
        self.cfg = cfg
        G, pg, tail = layout(cfg)
        if isinstance(tree["groups"], list):
            groups, tails = tree["groups"], tree.get("tail", [])
        else:  # each layer's slice copied out of its stack
            groups, tails = _split_stacks(cfg, tree)
            groups = [[{k: t.clone() for k, t in lp.items()} for lp in g]
                      for g in groups]
            tails = [{k: t.clone() for k, t in lp.items()} for lp in tails]
        if len(groups) != G or any(len(g) != pg for g in groups):
            raise ValueError(f"groups of {[len(g) for g in groups]}, "
                             f"expected {G} of {pg}")
        if len(tails) != tail:
            raise ValueError(f"{len(tails)} tail layers, expected {tail}")
        self.groups = tnn.ModuleList(
            [tnn.ModuleList([Mamba2Layer(t) for t in g]) for g in groups])
        self.tail = tnn.ModuleList([Mamba2Layer(t) for t in tails])
        self.shared_attn = transformer.DecoderLayer(tree["shared_attn"])
        for name in ("embed", "final_w", "lm_head"):
            setattr(self, name, tnn.Parameter(tree[name],
                                              requires_grad=False))


class TreeModel:
    """A parameter tree in the reference's layout seen as a ``Zamba2``:
    ``groups`` / ``tail`` namespaces of the stacks' slices (``unbind``,
    whose backward stacks the layers' gradients), ``shared_attn`` one
    namespace of the tree's own leaves."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        _check_kind(cfg)
        groups, tails = _split_stacks(cfg, tree)
        self.groups = [[SimpleNamespace(**lp) for lp in g] for g in groups]
        self.tail = [SimpleNamespace(**lp) for lp in tails]
        self.shared_attn = SimpleNamespace(**tree["shared_attn"])
        for name in ("embed", "final_w", "lm_head"):
            setattr(self, name, tree[name])


# --------------------------------------------------------------- forward
def _embed(cfg: ModelConfig, model, tokens):
    return parallel.embed_lookup(
        cfg, parallel.gather_leaf(model.embed, param_specs(cfg)["embed"]),
        tokens, torch_dtype(cfg.compute_dtype))


def _head(cfg: ModelConfig, model, x):
    """The final norm and the logits (the rank's vocab block on the
    model axis)."""
    specs = param_specs(cfg)
    x = nn.rms_norm(x, parallel.gather_leaf(model.final_w,
                                            specs["final_w"]))
    return parallel.unembed(cfg, x, parallel.gather_leaf(model.lm_head,
                                                         specs["lm_head"]))


def _mamba_gathered(cfg: ModelConfig, lp):
    """A Mamba2 layer's leaves, gathered over ``data`` where held in
    part (FSDP)."""
    return parallel.gather_layer(lp, mamba_layer_specs(cfg))


def _shared_gathered(cfg: ModelConfig, sp):
    return parallel.gather_layer(sp, shared_specs(cfg))


def _mamba_layer(cfg: ModelConfig, lp, x):
    lp = _mamba_gathered(cfg, lp)
    y, _ = mamba2.mamba2_block(cfg, lp, nn.rms_norm(x, lp.norm_in))
    return x + y


def _shared_attn(cfg: ModelConfig, sp, x, rope):
    sp = _shared_gathered(cfg, sp)
    a, _ = transformer.attn_block(cfg, sp, nn.rms_norm(x, sp.norm1_w), rope,
                                  window=cfg.window)
    x = x + a
    return x + transformer.mlp_block(cfg, sp, nn.rms_norm(x, sp.norm2_w))


def forward(cfg: ModelConfig, model, tokens, last_only: bool = False):
    """The scan path (training, ``registry.logits_fn`` and
    ``registry.prefill_fn``): tokens (B, T), T a multiple of the SSD chunk
    (or shorter than it) -> logits (B, T, V), or (B, 1, V) with
    ``last_only``."""
    x = _embed(cfg, model, tokens)
    rope = nn.rope_freqs(cfg.hd, x.shape[1] + 1, cfg.rope_theta, x.dtype,
                         device=x.device)
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def run(fn, h, *args):
        if remat:
            return checkpoint.checkpoint(fn, h, *args, use_reentrant=False)
        return fn(h, *args)

    for group in model.groups:
        for lp in group:
            x = run(lambda h, lp=lp: _mamba_layer(cfg, lp, h), x)
        x = run(lambda h: _shared_attn(cfg, model.shared_attn, h, rope), x)
    for lp in model.tail:
        x = run(lambda h, lp=lp: _mamba_layer(cfg, lp, h), x)
    if last_only:
        x = x[:, -1:]
    return _head(cfg, model, x)


def init_state(cfg: ModelConfig, batch: int, window_cache: int,
               device=None) -> Dict[str, torch.Tensor]:
    """The decode state on ``device`` (CUDA unless "cpu"): per Mamba2
    layer SSD states ``ssm_groups`` (G, every - 1, B, H, P, N) and
    ``ssm_tail`` (tail, B, H, P, N) f32, zeros; a KV ring per group
    ``attn_k`` / ``attn_v`` (G, B, W, HK, hd) in the compute dtype, zeros,
    W = max(window_cache, 1); ``kv_pos`` (B, W) int32, -1 (empty); ``pos``
    (B,) int32, zeros."""
    dev = resolve_device(device)
    G, pg, tail = layout(cfg)
    H, P, N = mamba2.heads(cfg)
    dt = torch_dtype(cfg.compute_dtype)
    W = max(int(window_cache), 1)
    f32, i32 = torch.float32, torch.int32
    kv = (G, batch, W, cfg.n_kv_heads, cfg.hd)
    return {
        "ssm_groups": torch.zeros((G, pg, batch, H, P, N), dtype=f32,
                                  device=dev),
        "ssm_tail": torch.zeros((tail, batch, H, P, N), dtype=f32,
                                device=dev),
        "attn_k": torch.zeros(kv, dtype=dt, device=dev),
        "attn_v": torch.zeros(kv, dtype=dt, device=dev),
        "kv_pos": torch.full((batch, W), -1, dtype=i32, device=dev),
        "pos": torch.zeros((batch,), dtype=i32, device=dev),
    }


def decode(cfg: ModelConfig, model, tokens, state):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), new state).
    Each sequence's position is ``state['pos']``, so the slots of a
    serving pool can sit at different depths; the state is not changed
    (new tensors are returned)."""
    x = _embed(cfg, model, tokens)
    B = x.shape[0]
    pos, kv_pos = state["pos"], state["kv_pos"]
    W = state["attn_k"].shape[2]
    write = (pos % W).long()
    rows = torch.arange(B, device=x.device)
    sp = _shared_gathered(cfg, model.shared_attn)
    ssm_groups: List[torch.Tensor] = []
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for g, group in enumerate(model.groups):
        states = []
        for i, lp in enumerate(group):
            lp = _mamba_gathered(cfg, lp)
            y, s = mamba2.mamba2_decode(cfg, lp, nn.rms_norm(x, lp.norm_in),
                                        state["ssm_groups"][g, i])
            x = x + y
            states.append(s)
        ssm_groups.append(torch.stack(states))
        kc, vc = state["attn_k"][g], state["attn_v"][g]
        a, (nk, nv) = transformer.attn_block_decode(
            cfg, sp, nn.rms_norm(x, sp.norm1_w), (kc, vc), pos=pos[:, None],
            kv_pos=kv_pos, window=cfg.window)
        # overwrite the oldest ring row (position pos - W, outside the
        # window, so the attention above never saw it)
        kc, vc = kc.clone(), vc.clone()
        kc[rows, write] = nk[:, 0].to(kc.dtype)
        vc[rows, write] = nv[:, 0].to(vc.dtype)
        ks.append(kc)
        vs.append(vc)
        x = x + a
        x = x + transformer.mlp_block(cfg, sp, nn.rms_norm(x, sp.norm2_w))
    tail_states = []
    for i, lp in enumerate(model.tail):
        lp = _mamba_gathered(cfg, lp)
        y, s = mamba2.mamba2_decode(cfg, lp, nn.rms_norm(x, lp.norm_in),
                                    state["ssm_tail"][i])
        x = x + y
        tail_states.append(s)
    logits = _head(cfg, model, x)
    new_kv_pos = kv_pos.clone()
    new_kv_pos[rows, write] = pos
    return logits, {
        "ssm_groups": torch.stack(ssm_groups),
        "ssm_tail": (torch.stack(tail_states) if tail_states
                     else state["ssm_tail"]),
        "attn_k": torch.stack(ks),
        "attn_v": torch.stack(vs),
        "kv_pos": new_kv_pos,
        "pos": pos + 1,
    }


def prefill(cfg: ModelConfig, model, tokens, window_cache: int,
            state=None):
    """Prompt prefill as a loop of one-token decodes, bitwise stepping
    ``decode`` (the slot-pool engine's oracle guarantee), from ``state``
    (default ``init_state``'s; on a mesh the rank's blocks of it,
    ``registry.init_decode_state(mesh=)``).  Returns (last-token logits
    (B, 1, V), the decode state at position T)."""
    B, T = tokens.shape
    if state is None:
        state = init_state(cfg, B, window_cache, tokens.device)
    logits = None
    for t in range(T):
        logits, state = decode(cfg, model, tokens[:, t:t + 1], state)
    return logits, state


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None, mesh=None, rules=None) -> Zamba2:
    """Random weights with the reference's init law from ``generator``
    (on ``device``, CUDA unless "cpu"), layer by layer: each leaf drawn in
    f32 (a layer's slice of a stack under the stack's law) and cast to the
    compute dtype as it is made.  Draw order: embed, the groups' layers,
    the tail's, then the shared block, final_w and lm_head.  On a
    ``mesh`` each leaf is this rank's block under ``rules``
    (``parallel.leaf_drawer``)."""
    specs = param_specs(cfg)
    G, pg, tail = layout(cfg)
    draw = parallel.leaf_drawer(cfg, generator, resolve_device(device),
                                mesh, rules)
    tree: Dict[str, Any] = {"embed": draw(specs["embed"])}
    tree["groups"] = [[{k: draw(s, 2) for k, s in specs["groups"].items()}
                       for _ in range(pg)] for _ in range(G)]
    tree["tail"] = [{k: draw(s, 1) for k, s in specs["tail"].items()}
                    for _ in range(tail)] if tail else []
    tree["shared_attn"] = nn.map_specs(lambda _, s: draw(s),
                                       specs["shared_attn"])
    for name in ("final_w", "lm_head"):
        tree[name] = draw(specs[name])
    return Zamba2(cfg, tree)
