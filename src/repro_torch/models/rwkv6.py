"""RWKV-6 "Finch" (attention-free, data-dependent decay): the port of
``repro.models.rwkv6``.

Time-mix recurrence per head (head dim K = 64 at full width):

    S_t = S_{t-1} diag(w_t) + k_t^T v_t            S in R^{K x K}
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with per-channel decay w_t = exp(-exp(dproj(x_t))).  The recurrence runs
through ``ops.wkv6``: the hand-written ``wkv6`` kernels on the card
(forward, and a reverse-time backward under autograd), ``ref.wkv6_ref``
on the CPU.  Two paths, as in the reference, and they round the decay
differently:

  * the scan path (``forward``: training, ``registry.logits_fn`` and
    ``registry.prefill_fn``) rounds w to the compute dtype before the
    recurrence and starts from a zero state (a state passed with T > 1 is
    ignored, as the reference's ``_wkv_scan`` ignores it);
  * the decode path (one token with a state: ``decode``, ``prefill`` (a
    loop of decodes), the serve engine and the naive loop) keeps w in f32.

In bf16 the two differ by a few percent of max|logit|, as the
reference's do.  The decay's ``exp`` is PyTorch's, not XLA's polynomial
(``core/f32.exp``): they differ in the last bits of f32 w, inside the
tests' bars, and the polynomial would put some 50 more launches into
every decode step of every layer.

``param_specs`` keeps the reference's tree, layer stacks on a leading
axis; ``Rwkv6`` holds one ``Rwkv6Layer`` module per layer under the
reference's parameter names (``tm_mix``, ``wr`` ... ``norm2_w``).  A
model built in the compute dtype (``init_model``) computes what the
reference computes on parameters cast to that dtype (its training's
cast): unlike the transformer, the mixes' sigmoid and the bonus read the
parameter's own dtype.  ``TreeModel`` views a parameter tree (the train
step's compute copy) with the module's attribute names.  ``cfg.remat``
other than ``none`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
the layer scan does.

On the mesh (``models.parallel``) each layer is gathered over ``data``
where its leaves are held in part (FSDP); over ``model`` the time mix
runs on the rank's ``H / model`` heads (``wr`` ... ``w_decay``
column-parallel, ``u_bonus`` and ``decay_bias`` the rank's blocks, the
wkv6 kernels at the rank's head count, ``ln_x`` normalising the whole
width, ``wo`` row-parallel), the channel mix's ``ck`` / ``cv`` are column-
/ row-parallel with ``cr`` whole, the embedding is vocab-parallel and
the logits are the rank's vocab block.  The decode state holds the
rank's heads of ``wkv``; its shift tokens may be held as the rank's block
of D (the engine's pool), gathered for each step.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn as tnn
from torch.utils import checkpoint

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models import nn, parallel
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.nn import ParamSpec


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.kind != "rwkv6":
        raise ValueError(f"kind={cfg.kind!r} is not rwkv6")


# ----------------------------------------------------------------- specs
def rwkv6_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {
        "tm_mix": ParamSpec((5, d), (None, "embed"), "zeros"),  # r,k,v,g,w
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "w_decay": ParamSpec((d, d), ("embed", "heads"), "normal", 0.1),
        "decay_bias": ParamSpec((d,), ("heads",), "zeros"),
        "u_bonus": ParamSpec((d,), ("heads",), "zeros"),
        "ln_x": ParamSpec((d,), ("heads",), "ones"),
        "cm_mix": ParamSpec((2, d), (None, "embed"), "zeros"),
        "ck": ParamSpec((d, cfg.d_ff), ("embed", "mlp")),
        "cv": ParamSpec((cfg.d_ff, d), ("mlp", "embed")),
        "cr": ParamSpec((d, d), ("embed", "embed")),
        "norm1_w": ParamSpec((d,), ("embed",), "ones"),
        "norm2_w": ParamSpec((d,), ("embed",), "ones"),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_kind(cfg)

    def stack(_, spec: ParamSpec) -> ParamSpec:
        return ParamSpec((cfg.n_layers,) + spec.shape,
                         ("layers",) + spec.axes, spec.init, spec.scale,
                         spec.dtype)

    return {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab_in", "embed"), "embed"),
        "layers": nn.map_specs(stack, rwkv6_specs(cfg)),
        "final_w": ParamSpec((cfg.d_model,), ("embed",), "ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab")),
    }


def heads(cfg: ModelConfig) -> tuple:
    """(H, K) of the time mix: H = n_heads, or d / 64 without it."""
    H = cfg.n_heads if cfg.n_heads else cfg.d_model // 64
    return H, cfg.d_model // H


# --------------------------------------------------------------- modules
class Rwkv6Layer(tnn.Module):
    """One layer's parameters under the reference's names."""

    def __init__(self, tree: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tree.items():
            setattr(self, name, tnn.Parameter(t, requires_grad=False))


class Rwkv6(tnn.Module):
    """The model: ``embed``, ``layers`` (one Rwkv6Layer each), ``final_w``,
    ``lm_head``.  Built from a parameter tree in the reference's layout
    (layer stacks on a leading axis; each layer's slice is copied out),
    or with ``tree["layers"]`` a list of one tree per layer, taken as it
    is."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        _check_kind(cfg)
        self.cfg = cfg
        L = cfg.n_layers
        layers = tree["layers"]
        if not isinstance(layers, list):
            for name, t in layers.items():
                if t.shape[0] != L:
                    raise ValueError(f"layer stack {name} of {t.shape[0]}, "
                                     f"expected {L}")
            layers = [{k: t[i].clone() for k, t in layers.items()}
                      for i in range(L)]
        if len(layers) != L:
            raise ValueError(f"{len(layers)} layers, expected {L}")
        self.layers = tnn.ModuleList([Rwkv6Layer(t) for t in layers])
        for name, t in tree.items():
            if name != "layers":
                setattr(self, name, tnn.Parameter(t, requires_grad=False))


class TreeModel:
    """A parameter tree in the reference's layout seen as an ``Rwkv6``:
    the top-level leaves as attributes and ``layers``, one namespace a
    layer of the stacks' slices (``unbind``, whose backward stacks the
    layers' gradients in one op)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        _check_kind(cfg)
        L = cfg.n_layers
        stacks = {}
        for name, t in tree["layers"].items():
            if t.shape[0] != L:
                raise ValueError(f"layer stack {name} of {t.shape[0]}, "
                                 f"expected {L}")
            stacks[name] = t.unbind(0)
        self.layers = [SimpleNamespace(**{k: s[i] for k, s in stacks.items()})
                       for i in range(L)]
        for name, t in tree.items():
            if name != "layers":
                setattr(self, name, t)


# --------------------------------------------------------------- layers
def _token_shift(x, prev=None):
    """The x_{t-1} stream; ``prev`` (B, 1, D) for decode continuity."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return prev


def _mixes(x, xp, mix, group=None):
    """x (1 - m_i) + xp m_i for each row m_i of ``mix`` (n, D), as one
    (n, ...) tensor's slices: each product and the sum rounded in x's
    dtype, as the reference's bf16 fusion rounds after every op (four
    launches for all n, where a decode step is host-bound).  With
    ``group`` they enter a tensor-parallel region (``copy_to``: one
    all-reduce of their gradient)."""
    m = mix.reshape((mix.shape[0],) + (1,) * (x.dim() - 1) + mix.shape[1:])
    return coll.copy_to(x * (1 - m) + xp * m, group).unbind(0)


def _tm_tp(cfg: ModelConfig, p):
    """The model axis when the time mix runs on the rank's heads (``wr``
    held in column blocks), else None."""
    t = parallel.tp()
    if t is None or not parallel.held_in_part(p.wr, 1, cfg.d_model):
        return None
    if heads(cfg)[0] % t.size:
        raise NotImplementedError(
            f"{heads(cfg)[0]} rwkv6 heads do not split over a model axis "
            f"of {t.size}: the time mix runs whole heads")
    return t


def time_mix(cfg: ModelConfig, p, x, state=None, prev_token=None):
    """state: (B, H, K, K) f32 or None.  Returns (out, new_state,
    last_token).  One token with a state takes the decode path (w in
    f32, the state carried); otherwise the scan path (w rounded to x's
    dtype, a zero state).  On the model axis (``_tm_tp``) the receptance,
    key, value, gate and decay are column-parallel, the recurrence runs
    on the rank's ``H / model`` heads (``state`` holds them), ``ln_x``
    normalises over the whole width (``nn.rms_norm(group=)``) and ``wo``
    is row-parallel."""
    H, K = heads(cfg)
    B, T = x.shape[:2]
    t = _tm_tp(cfg, p)
    group = None if t is None else t.group
    if t is not None:
        H //= t.size
    xp = _token_shift(x, prev_token)
    mix = torch.sigmoid(p.tm_mix).to(x.dtype)  # (5, D)
    xr, xk, xv, xg, xw = _mixes(x, xp, mix, group)
    r = nn.dense(xr, p.wr).reshape(B, T, H, K)
    k = nn.dense(xk, p.wk).reshape(B, T, H, K)
    v = nn.dense(xv, p.wv).reshape(B, T, H, K)
    g = F.silu(nn.dense(xg, p.wg))
    dlog = nn.dense(xw, p.w_decay) + p.decay_bias.to(x.dtype)
    w = torch.exp(-torch.exp(dlog.to(torch.float32))).reshape(B, T, H, K)
    u = p.u_bonus.to(torch.float32).reshape(H, K)
    if T == 1 and state is not None:
        y, new_state = ops.wkv6(r, k, v, w, u, state)
    else:
        y, new_state = ops.wkv6(r, k, v, w.to(x.dtype), u)
    y = nn.rms_norm(y.reshape(B, T, -1).to(x.dtype), p.ln_x,
                    group=group) * g
    return nn.row_parallel(y, p.wo, group), new_state, x[:, -1:, :]


def channel_mix(cfg: ModelConfig, p, x, prev_token=None):
    """On the model axis, where ``ck`` is held in column blocks, the key
    is column-parallel and ``cv`` row-parallel; ``cr`` runs whole."""
    xp = _token_shift(x, prev_token)
    mix = torch.sigmoid(p.cm_mix).to(x.dtype)
    xk, xr = _mixes(x, xp, mix)
    t = parallel.tp()
    group = (t.group if t is not None
             and parallel.held_in_part(p.ck, 1, cfg.d_ff) else None)
    k = torch.square(F.relu(nn.dense(coll.copy_to(xk, group), p.ck)))
    return (torch.sigmoid(nn.dense(xr, p.cr)) * nn.row_parallel(k, p.cv,
                                                                 group),
            x[:, -1:, :])


def rwkv6_layer(cfg: ModelConfig, p, x, state=None, prev_tm=None,
                prev_cm=None):
    """One layer; its leaves gathered over ``data`` first where they are
    held in part (FSDP)."""
    p = parallel.gather_layer(p, rwkv6_specs(cfg))
    a, new_state, last_tm = time_mix(cfg, p, nn.rms_norm(x, p.norm1_w),
                                     state, prev_tm)
    x = x + a
    b, last_cm = channel_mix(cfg, p, nn.rms_norm(x, p.norm2_w), prev_cm)
    return x + b, new_state, last_tm, last_cm


# ----------------------------------------------------------- full model
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


def forward(cfg: ModelConfig, model, tokens, last_only: bool = False):
    """The scan path -> logits (B, T, V), or (B, 1, V) with
    ``last_only``.  Under autograd with ``cfg.remat`` other than ``none``
    each layer is checkpointed: its forward runs again in the
    backward."""
    x = _embed(cfg, model, tokens)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for lp in model.layers:
        if remat:
            x = checkpoint.checkpoint(
                lambda h, lp=lp: rwkv6_layer(cfg, lp, h)[0], x,
                use_reentrant=False)
        else:
            x = rwkv6_layer(cfg, lp, x)[0]
    if last_only:
        x = x[:, -1:]
    return _head(cfg, model, x)


def init_state(cfg: ModelConfig, batch: int, device=None):
    """The decode state: ``wkv`` (L, B, H, K, K) f32 and the shift tokens
    ``prev_tm`` / ``prev_cm`` (L, B, 1, D) in the compute dtype, zeros,
    on ``device`` (CUDA unless "cpu")."""
    dev = resolve_device(device)
    H = cfg.n_heads
    K = cfg.d_model // H
    dt = torch_dtype(cfg.compute_dtype)
    L, D = cfg.n_layers, cfg.d_model
    return {
        "wkv": torch.zeros((L, batch, H, K, K), dtype=torch.float32,
                           device=dev),
        "prev_tm": torch.zeros((L, batch, 1, D), dtype=dt, device=dev),
        "prev_cm": torch.zeros((L, batch, 1, D), dtype=dt, device=dev),
    }


def decode(cfg: ModelConfig, model, tokens, state):
    """One-token decode carrying per-layer (wkv state, shift tokens):
    tokens (B, 1) -> (logits (B, 1, V), new state).  On the model axis
    ``wkv`` holds the rank's heads, and the shift tokens may be held as
    the rank's block of D (``registry.decode_state_shardings``): they are
    gathered whole over ``model`` for the step, and the new ones are
    returned as the rank's block."""
    x = _embed(cfg, model, tokens)
    ptm_all, pcm_all = state["prev_tm"], state["prev_cm"]
    t = parallel.tp()
    split = t is not None and ptm_all.shape[-1] < cfg.d_model
    if split:
        ptm_all = coll.all_gather(ptm_all, -1, t.group)
        pcm_all = coll.all_gather(pcm_all, -1, t.group)
    wkv, ptm, pcm = [], [], []
    for i, lp in enumerate(model.layers):
        x, s, ltm, lcm = rwkv6_layer(cfg, lp, x, state=state["wkv"][i],
                                     prev_tm=ptm_all[i], prev_cm=pcm_all[i])
        wkv.append(s)
        ptm.append(ltm)
        pcm.append(lcm)
    ptm, pcm = torch.stack(ptm), torch.stack(pcm)
    if split:
        n = cfg.d_model // t.size
        ptm, pcm = (y.narrow(-1, t.rank * n, n).contiguous()
                    for y in (ptm, pcm))
    return _head(cfg, model, x), {
        "wkv": torch.stack(wkv), "prev_tm": ptm, "prev_cm": pcm}


def prefill(cfg: ModelConfig, model, tokens, state=None):
    """Prompt prefill as a loop of single-token decodes, bitwise stepping
    ``decode`` token by token (the slot-pool engine's oracle guarantee),
    from ``state`` (default ``init_state``'s zeros; on a mesh the rank's
    blocks of them, ``registry.init_decode_state(mesh=)``).  Returns
    (last-token logits (B, 1, V), decode state after the prompt)."""
    B, T = tokens.shape
    if state is None:
        state = init_state(cfg, B, tokens.device)
    logits = None
    for t in range(T):
        logits, state = decode(cfg, model, tokens[:, t:t + 1], state)
    return logits, state


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None, mesh=None, rules=None) -> Rwkv6:
    """Random weights with the reference's init law from ``generator``
    (on ``device``, CUDA unless "cpu"), layer by layer: each leaf drawn in
    f32 (a layer's slice of a stack under the stack's law) and cast to
    the compute dtype as it is made.  Draw order: embed, each layer's
    leaves, then final_w and lm_head.  On a ``mesh`` each leaf is this
    rank's block under ``rules`` (``parallel.leaf_drawer``)."""
    specs = param_specs(cfg)
    draw = parallel.leaf_drawer(cfg, generator, resolve_device(device),
                                mesh, rules)
    tree: Dict[str, Any] = {"embed": draw(specs["embed"])}
    tree["layers"] = [{k: draw(s, 1) for k, s in specs["layers"].items()}
                      for _ in range(cfg.n_layers)]
    for name, spec in specs.items():
        if name not in tree:
            tree[name] = draw(spec)
    return Rwkv6(cfg, tree)
