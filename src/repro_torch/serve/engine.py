"""Continuous-batching decode engine over a fixed pool of KV-cache slots
(the port of ``repro.serve.engine``).

Requests stream through three phases:

  prefill(model, tokens)  -> (logits, Prefix)   # run the prompt
  insert(state, prefix, slot)                   # copy prefix -> slot
  generate_step(model, state) -> (state, tokens, done)

Each slot is independent: slots sit at different depths (per-slot
``lengths``), finish at different times (EOS / per-request ``max_gen`` /
cache capacity) and are re-inserted into without touching neighbours.
Inactive slots are frozen bitwise, which makes full-occupancy engine
decode token-identical to the naive loop (``serve.oracle``).

Unlike the reference, which returns new arrays, the port updates the
cache in place: ``insert`` writes the prompt's rows and the state's
bookkeeping into the given state, and ``generate_step`` writes each
active slot's new KV row into the cache (``select``: an inactive slot's
row is written back unchanged) and returns new bookkeeping tensors.

Families: dense and moe (slot-pool KV cache with ``valid_len`` masking:
rows past a slot's length score -1e30 and contribute exactly 0; a moe
decode step routes the slots' tokens as one call), rwkv6 (a
constant-size recurrent state per slot, no capacity limit; its prefill
is ``rwkv6.prefill``, a loop of one-token decodes) and zamba2 (per-layer
SSD states and a per-group KV ring of ``min(window, max_seq_len)`` rows
masked by absolute position; its prefill is ``zamba2.prefill``, a loop
of one-token decodes).  whisper / llava need per-request side inputs
and raise as in the reference.

On a mesh (``mesh=``, else the active one; every kind the engine
serves): the model's weights are resident by ``SERVE_RESIDENT_RULES``
(each rank holds its tensor-parallel blocks; a moe config with
``moe_ep`` reshards the experts at use, ``parallel.rank_experts``) and
the cache follows ``registry.decode_state_shardings``: the rank's KV
heads, or its rows of the sequence when the heads do not split over
'model'; rwkv6's and zamba2's state the rank's heads (rwkv6's shift
tokens its block of D, gathered for each step), a prompt prefilled from
a one-slot state split over 'model' alone.  Slots split over
the batch axes as ``batch_spec`` splits them: each rank steps its own
slots, and the tokens of all slots are gathered, so every rank runs the
same loop (the bookkeeping is replicated; every rank prefills each
prompt, and only the rank holding the slot keeps its cache).  A moe
decode step routes the rank's slots as one call, with their capacity,
as the reference's ``shard_map`` routes its shard's; a prefill, one
prompt, is routed whole on every rank.  Greedy
tokens are an argmax over the vocabulary's blocks, ties to the lowest
global index (``parallel.argmax_vocab``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist import meshctx, sharding
from repro_torch.models import parallel, registry, rwkv6, transformer, zamba2
from repro_torch.models.config import ModelConfig, torch_dtype


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    max_prefill_len: int = 64
    max_gen_len: int = 32
    eos_id: Optional[int] = None

    @property
    def max_seq_len(self) -> int:
        return self.max_prefill_len + self.max_gen_len


@dataclasses.dataclass
class Prefix:
    """A prefilled prompt, ready to insert into a slot."""

    cache: Any                # per-family cache tree, batch dim = 1
    length: int               # prompt length P
    next_token: torch.Tensor  # () int32: the first generated token
    last_logits: torch.Tensor  # (1, 1, V) last-position prompt logits


# ------------------------------------------------------------- families
class _DenseFamily:
    """dense and moe: preallocated (L, N, S_max, HK, hd) KV slot pool.
    ``decoder_decode_slots`` masks rows >= lengths[slot] with -1e30, so
    stale rows contribute exact-zero probability; per-slot RoPE comes
    from position-direct ``rope_at``.  On a mesh the pool is this rank's
    block of it (``decode_state_shardings``)."""

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 device: torch.device, mesh=None):
        self.cfg, self.ecfg, self.device = cfg, ecfg, device
        self.capacity = ecfg.max_seq_len
        self.seq = None  # (model group, first row) of a sequence split
        self.spec = None
        self.slot_axes = set()
        if mesh is not None:
            self.spec = registry.decode_state_shardings(
                cfg, mesh, ecfg.max_slots, ecfg.max_seq_len)["k"].spec
            self.slot_axes = sharding.spec_axes(self.spec[1:2])
            if "model" in sharding.spec_axes(self.spec[2:3]):
                rows = ecfg.max_seq_len // mesh.shape["model"]
                self.seq = (mesh.group("model"), mesh.coord("model") * rows)
        self.mesh = mesh

    def init_cache(self) -> Dict[str, torch.Tensor]:
        if self.spec is None:
            return registry.init_decode_state(
                self.cfg, self.ecfg.max_slots, self.ecfg.max_seq_len,
                self.device)
        specs = registry.decode_state_specs(
            self.cfg, self.ecfg.max_slots, self.ecfg.max_seq_len)
        return {k: torch.zeros(sharding.shard_shape(s.shape, self.spec,
                                                    self.mesh),
                               dtype=s.dtype, device=self.device)
                for k, s in specs.items()}

    def prefill(self, model, tokens):
        logits, (k, v) = transformer.forward(self.cfg, model, tokens,
                                             last_only=True)
        return logits, {"k": k, "v": v}

    def insert(self, cache, prefix_cache, slot: int) -> None:
        if self.seq is None:
            P = prefix_cache["k"].shape[2]
            for k in ("k", "v"):
                cache[k][:, slot, :P] = prefix_cache[k][:, 0]
            return
        row0 = self.seq[1]  # this rank's rows of the prompt
        rows = cache["k"].shape[2]
        n = min(max(prefix_cache["k"].shape[2] - row0, 0), rows)
        for k in ("k", "v"):
            cache[k][:, slot, :n] = prefix_cache[k][:, 0, row0:row0 + n]

    def step(self, model, tokens, cache, lengths, keep):
        """Logits of one decode step; writes the kept slots' new rows
        into ``cache`` (the select merge, see the module docstring)."""
        cfg = self.cfg
        x = transformer.embed_tokens(cfg, model, tokens,
                                     torch_dtype(cfg.compute_dtype))
        y, _ = transformer.decoder_decode_slots(
            cfg, model, x, (cache["k"], cache["v"]), lengths, keep=keep,
            seq=self.seq)
        y = transformer.final_norm(cfg, model, y)
        return transformer.unembed(cfg, model, y)


class _Recurrent:
    """rwkv6 and zamba2 on one rank or a mesh: the state's leaves are
    this rank's blocks under ``registry.decode_state_shardings`` (its
    slots, its heads), and a prompt is prefilled on every rank from the
    blocks of a one-slot state split only over 'model'."""

    _AXES: Dict[str, int] = {}  # the slot axis of each state leaf

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 device: torch.device, mesh=None):
        self.cfg, self.ecfg, self.device, self.mesh = cfg, ecfg, device, mesh
        self.slot_axes = (set() if mesh is None else sharding.spec_axes(
            sharding.batch_spec(mesh, 1, ecfg.max_slots)))

    def init_cache(self) -> Dict[str, torch.Tensor]:
        return registry.init_decode_state(
            self.cfg, self.ecfg.max_slots, self.ecfg.max_seq_len,
            self.device, self.mesh)

    def _prefill_state(self):
        return registry.init_decode_state(
            self.cfg, 1, self.ecfg.max_seq_len, self.device, self.mesh,
            axes=("model",))

    def insert(self, cache, prefix_cache, slot: int) -> None:
        for k, c in cache.items():
            a = self._AXES[k]
            c.select(a, slot).copy_(prefix_cache[k].select(a, 0))

    def _select(self, cache, new, keep) -> None:
        """Each kept slot's new state written into ``cache``, the others'
        left as they were (the reference's select along each leaf's slot
        axis)."""
        for k, c in cache.items():
            a = self._AXES[k]
            sel = keep.reshape((1,) * a + (-1,) + (1,) * (c.dim() - a - 1))
            c.copy_(torch.where(sel, new[k], c))


class _Rwkv6Family(_Recurrent):
    """rwkv6: constant-size recurrent state per slot (the wkv matrices
    and the two shift tokens, (L, N, ...) each); no capacity limit.  On a
    mesh the shift tokens are held as the rank's block of D and gathered
    whole for each step (``rwkv6.decode``)."""

    _AXES = {"wkv": 1, "prev_tm": 1, "prev_cm": 1}

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 device: torch.device, mesh=None):
        super().__init__(cfg, ecfg, device, mesh)
        self.capacity = None  # recurrent: no cache-length limit

    def prefill(self, model, tokens):
        return rwkv6.prefill(self.cfg, model, tokens, self._prefill_state())

    def step(self, model, tokens, cache, lengths, keep):
        """Logits of one decode step; the kept slots' new state written
        into ``cache``."""
        logits, new = rwkv6.decode(self.cfg, model, tokens, cache)
        self._select(cache, new, keep)
        return logits


class _Zamba2Family(_Recurrent):
    """zamba2: per-layer SSD states and a per-group shared-attention KV
    ring, masked by each row's absolute position (``kv_pos``).  The state
    carries each slot's own ``pos``; the engine's ``lengths`` mirror it.
    With a window the ring is ``min(window, max_seq_len)`` rows and slides
    (no capacity limit); without one it is max_seq_len rows and must not
    wrap."""

    _AXES = {"ssm_groups": 2, "ssm_tail": 1, "attn_k": 1, "attn_v": 1,
             "kv_pos": 0, "pos": 0}

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig,
                 device: torch.device, mesh=None):
        super().__init__(cfg, ecfg, device, mesh)
        if cfg.window:
            self.window_cache = min(cfg.window, ecfg.max_seq_len)
            self.capacity = None  # the ring slides under the window
        else:
            self.window_cache = ecfg.max_seq_len  # the ring must not wrap
            self.capacity = ecfg.max_seq_len

    def prefill(self, model, tokens):
        return zamba2.prefill(self.cfg, model, tokens, self.window_cache,
                              self._prefill_state())

    def step(self, model, tokens, cache, lengths, keep):
        """Logits of one decode step; the kept slots' new state written
        into ``cache``."""
        logits, new = zamba2.decode(self.cfg, model, tokens, cache)
        self._select(cache, new, keep)
        return logits


def _make_family(cfg: ModelConfig, ecfg: EngineConfig, device, mesh=None):
    if cfg.kind in ("dense", "moe"):
        return _DenseFamily(cfg, ecfg, device, mesh)
    if cfg.kind == "rwkv6":
        return _Rwkv6Family(cfg, ecfg, device, mesh)
    if cfg.kind == "zamba2":
        return _Zamba2Family(cfg, ecfg, device, mesh)
    raise NotImplementedError(
        f"serve engine does not support kind={cfg.kind!r} "
        "(whisper/llava need per-request frames/patches)")


# --------------------------------------------------------------- engine
class ServeEngine:
    """Fixed-slot continuous-batching engine for one model family, on
    ``device`` (CUDA unless "cpu")."""

    def __init__(self, cfg: ModelConfig, *, max_slots: int = 4,
                 max_prefill_len: int = 64, max_gen_len: int = 32,
                 eos_id: Optional[int] = None, device=None, mesh=None):
        self.cfg = cfg
        self.ecfg = EngineConfig(max_slots, max_prefill_len, max_gen_len,
                                 eos_id)
        self.device = resolve_device(device)
        mesh = meshctx.active_mesh() if mesh is None else mesh
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.family = _make_family(cfg, self.ecfg, self.device, self.mesh)
        # this rank's slots [lo, lo + n) and the group they split over
        self.slots, self.slot_group = (0, max_slots), None
        if self.mesh is not None:
            axes = self.family.slot_axes
            if axes:
                names = tuple(a for a in self.mesh.axis_names if a in axes)
                n = max_slots // self.mesh.axis_size(names)
                self.slots = (self.mesh.coord(names) * n, n)
                self.slot_group = self.mesh.group(names)

    # ---------------------------------------------------------- state
    def init_state(self) -> Dict[str, Any]:
        N = self.ecfg.max_slots

        def i32():
            return torch.zeros((N,), dtype=torch.int32, device=self.device)

        return {
            "cache": self.family.init_cache(),
            "tokens": i32(),    # last emitted token per slot
            "lengths": i32(),   # sequence depth (cache rows in use)
            "gen": i32(),       # tokens emitted so far per request
            "max_gen": i32(),   # per-request generation budget
            "active": torch.zeros((N,), dtype=torch.bool,
                                  device=self.device),
        }

    def occupancy(self, state) -> float:
        return float(state["active"].cpu().float().mean())

    def free_slots(self, state):
        return [int(i) for i in torch.nonzero(~state["active"].cpu())[:, 0]]

    def _greedy(self, logits) -> torch.Tensor:
        # argmax takes the first maximal index, as jnp.argmax does
        tok = parallel.argmax_vocab(self.cfg, logits[:, -1])
        return torch.clamp(tok, 0, self.cfg.vocab - 1).to(torch.int32)

    # -------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, model, tokens) -> Tuple[torch.Tensor, Prefix]:
        """Run one prompt (1-d or (1, P) ints).  Returns (last-position
        logits (1, 1, V), Prefix)."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int32)
        if tokens.dim() == 1:
            tokens = tokens[None]
        P = tokens.shape[1]
        if not 0 < P <= self.ecfg.max_prefill_len:
            raise ValueError(
                f"prompt length {P} not in (0, {self.ecfg.max_prefill_len}]")
        with meshctx.use_mesh(self.mesh):
            logits, cache = self.family.prefill(model, tokens)
            tok = self._greedy(logits)[0]
        return logits, Prefix(cache=cache, length=P, next_token=tok,
                              last_logits=logits)

    # --------------------------------------------------------- insert
    @torch.no_grad()
    def insert(self, state, prefix: Prefix, slot: int,
               max_gen: Optional[int] = None) -> Dict[str, Any]:
        """Copy a prefilled prompt into ``slot`` of ``state`` (in place,
        evicting whatever was there) and return the state.  ``max_gen``
        caps this request's emitted tokens (prefill token included),
        clamped to the engine budget."""
        mg = self.ecfg.max_gen_len if max_gen is None else int(max_gen)
        mg = max(1, min(mg, self.ecfg.max_gen_len))
        lo, n = self.slots
        if lo <= slot < lo + n:  # the rank holding the slot keeps its cache
            self.family.insert(state["cache"], prefix.cache, slot - lo)
        state["tokens"][slot] = prefix.next_token
        state["lengths"][slot] = prefix.length
        state["gen"][slot] = 1  # the prefill emitted one
        state["max_gen"][slot] = mg
        state["active"][slot] = mg > 1
        return state

    # ----------------------------------------------------------- step
    @torch.no_grad()
    def generate_step(self, model, state):
        """One batched decode step over every slot.  Returns (new_state,
        tokens (N,), done (N,)); ``tokens[i]`` is fresh only where
        ``state['active'][i]`` was True, and ``done`` marks slots that
        just finished (EOS / max_gen / capacity).  The cache is updated
        in place and shared with the new state."""
        active = state["active"]
        cache = state["cache"]
        lo, n = self.slots
        with meshctx.use_mesh(self.mesh):
            logits = self.family.step(
                model, state["tokens"][lo:lo + n, None], cache,
                state["lengths"][lo:lo + n], active[lo:lo + n])
            greedy = coll.all_gather(self._greedy(logits), 0,
                                     self.slot_group)
        tok = torch.where(active, greedy, state["tokens"])
        act = active.to(torch.int32)
        gen = state["gen"] + act
        lengths = state["lengths"] + act
        done = active & (gen >= state["max_gen"])
        if self.ecfg.eos_id is not None:
            done = done | (active & (tok == self.ecfg.eos_id))
        if self.family.capacity is not None:
            done = done | (active & (lengths >= self.family.capacity))
        new_state = {
            "cache": cache,
            "tokens": tok,
            "lengths": lengths,
            "gen": gen,
            "max_gen": state["max_gen"],
            "active": active & ~done,
        }
        return new_state, tok, done
