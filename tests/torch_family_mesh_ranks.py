"""Rank sides of tests/test_torch_{rwkv6,zamba2,whisper}_mesh.py: each
function runs in one of the gloo ranks that ``torch_ranks.run_ranks``
spawns (several in one spawn through ``torch_moe_mesh_ranks.jobs_side``),
builds the (pod, data, model) mesh over them and drives one path of the
rwkv6, zamba2 or whisper model on it.  Imports torch and the port only,
so the ranks start without JAX."""
from __future__ import annotations

from torch_mesh_ranks import _cfg, _engine_tokens, _gather_vocab, _mesh, _tree


def _model(cfg, params, mesh, rules="SERVE_RESIDENT_RULES"):
    """The family's model from the reference's params, each rank cutting
    its blocks under ``rules`` (whole without a ``mesh``)."""
    from repro_torch.dist import sharding
    from repro_torch.models import registry, rwkv6, whisper, zamba2

    tree = _tree(params)
    if mesh is not None:
        tree = sharding.shard_tree(tree, sharding.param_shardings(
            registry.param_specs(cfg), mesh, getattr(sharding, rules)))
    cls = {"rwkv6": rwkv6.Rwkv6, "zamba2": zamba2.Zamba2,
           "whisper": whisper.Whisper}[cfg.kind]
    return cls(cfg, tree)


def _batch(tokens, frames=None):
    import torch

    b = {"tokens": torch.from_numpy(tokens)}
    if frames is not None:
        b["frames"] = torch.from_numpy(frames)
    return b


def _local_shapes(model) -> dict:
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def forward_side(rank: int, n: int, group, shape, arch: str, params,
                 tokens, frames=None) -> dict:
    """The family's forward (``registry.logits_fn``) on ``shape`` with the
    weights resident by SERVE_RESIDENT_RULES: its logits in f32 and in
    bf16 (from the same blocks), whole over the vocabulary, and every
    parameter's local shape."""
    import torch

    from repro_torch.models import registry

    mesh = _mesh(shape)
    cfg = _cfg(arch)
    model = _model(cfg, params, mesh)
    batch = _batch(tokens, frames)
    bf16 = cfg.scaled(compute_dtype="bfloat16")
    with torch.no_grad():
        logits = _gather_vocab(cfg, registry.logits_fn(cfg, model, batch))
        logits_bf16 = _gather_vocab(bf16, registry.logits_fn(
            bf16, model, batch).to(torch.float32))
    return {"coords": mesh.coords(), "logits": logits.numpy(),
            "logits_bf16": logits_bf16.numpy(),
            "local_shapes": _local_shapes(model)}


def _whole_state(cfg, mesh, state, batch: int, seq_len: int) -> dict:
    """A decode state held as the rank's blocks over 'model' gathered
    whole."""
    from repro_torch.dist import sharding
    from repro_torch.models import registry

    shards = registry.decode_state_shardings(cfg, mesh, batch, seq_len)
    return {k: sharding.unshard(v, shards[k].spec, mesh,
                                axes=("model",)).numpy()
            for k, v in state.items()}


def serve_side(rank: int, n: int, group, shape, arch: str, params, prompts,
               n_gen: int, requests, chain) -> dict:
    """rwkv6 or zamba2 on ``shape``, weights by SERVE_RESIDENT_RULES, in
    f32: the engine's tokens at full occupancy, the naive loop's and
    ``launch.serve.drive``'s over ``requests``; the decode state after
    ``registry.serve_fn`` steps over the tokens of ``chain`` (B, T) from
    a fresh state, gathered whole; the engine pool's local shapes."""
    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine, naive_generate

    mesh = _mesh(shape)
    cfg = _cfg(arch)
    model = _model(cfg, params, mesh)
    P = prompts.shape[1]
    engine = ServeEngine(cfg, max_slots=prompts.shape[0], max_prefill_len=P,
                         max_gen_len=n_gen, device="cpu")
    toks = _engine_tokens(engine, model, prompts, n_gen)
    naive = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                           n_gen).numpy()
    outputs, _ = launch.drive(
        ServeEngine(cfg, max_slots=2, max_prefill_len=P, max_gen_len=n_gen,
                    device="cpu"), model, requests)
    B, T = chain.shape
    state = registry.init_decode_state(cfg, B, T, "cpu", mesh,
                                       axes=("model",))
    serve = registry.serve_fn(cfg)
    with torch.no_grad():
        for t in range(T):
            logits, state = serve(model, {"tokens": torch.from_numpy(
                chain[:, t:t + 1])}, state)
        logits = _gather_vocab(cfg, logits)
    return {"coords": mesh.coords(), "engine": toks, "naive": naive,
            "drive": outputs, "chain_logits": logits.numpy(),
            "state": _whole_state(cfg, mesh, state, B, T),
            "pool": {k: tuple(v.shape)
                     for k, v in engine.init_state()["cache"].items()}}


def whisper_cache(cfg, model, tokens, frames):
    """A prompt's decode cache on the mesh: the cross K / V of every
    decoder layer over the encoder memory (``whisper.cross_kv``: the
    rank's heads), and the prompt's self K / V from the decoder's layers
    run in turn (the rank's heads), as chip_smoke.py builds them on one
    rank."""
    import torch

    from repro_torch.models import nn, whisper

    memory = whisper.encode(cfg, model, frames)
    cross = [whisper.cross_kv(cfg, lp, memory) for lp in model.dec_layers]
    x = whisper._embed(cfg, model, tokens)
    rope = nn.rope_freqs(cfg.hd, x.shape[1] + 1, cfg.rope_theta, x.dtype)
    ks, vs = [], []
    for lp in model.dec_layers:
        x, (k, v) = whisper._dec_layer(cfg, lp, x, memory, rope)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs),
            "cross_k": torch.stack([c[0] for c in cross]),
            "cross_v": torch.stack([c[1] for c in cross])}


def whisper_chain(cfg, model, prompt, frames, n_steps: int):
    """Greedy ``serve_fn`` steps after a prompt (its last token fed
    first), each appending its new self K / V: (tokens (B, n_steps), the
    steps' logits whole over the vocabulary)."""
    import torch

    from repro_torch.models import parallel, registry

    cache = whisper_cache(cfg, model, prompt[:, :-1], frames)
    serve = registry.serve_fn(cfg)
    tok, out, logits = prompt[:, -1:], [], []
    for _ in range(n_steps):
        lg, (nk, nv) = serve(model, {"tokens": tok}, cache)
        cache["k"] = torch.cat([cache["k"], nk], 2)
        cache["v"] = torch.cat([cache["v"], nv], 2)
        tok = parallel.argmax_vocab(cfg, lg).to(torch.int32)
        out.append(tok)
        logits.append(_gather_vocab(cfg, lg))
    return torch.cat(out, 1), torch.cat(logits, 1), cache


def whisper_serve_side(rank: int, n: int, group, shape, arch: str, params,
                       prompt, frames, n_steps: int) -> dict:
    """whisper on ``shape``, weights by SERVE_RESIDENT_RULES, in f32: the
    ``prefill_fn`` logits of the prompt and a ``serve_fn`` chain of
    ``n_steps`` greedy steps (tokens, logits), with its cache's local
    shapes."""
    import torch

    from repro_torch.models import registry

    mesh = _mesh(shape)
    cfg = _cfg(arch)
    model = _model(cfg, params, mesh)
    t, f = torch.from_numpy(prompt), torch.from_numpy(frames)
    with torch.no_grad():
        last, cache = registry.prefill_fn(cfg)(model, {"tokens": t,
                                                       "frames": f})
        toks, logits, kv = whisper_chain(cfg, model, t, f, n_steps)
    return {"coords": mesh.coords(), "prefill": _gather_vocab(
        cfg, last).numpy(), "prefill_cache": cache is None,
        "tokens": toks.numpy(), "logits": logits.numpy(),
        "cache": {k: tuple(v.shape) for k, v in kv.items()}}


def norm_side(rank: int, n: int, group, x, w, c) -> dict:
    """``nn.rms_norm(group=)`` on this rank's block of the last dim of x
    (and of the weight), differentiated through sum(y * c): the rank's
    blocks of y and of the gradients of x and w."""
    import torch

    from repro_torch.models import nn

    b = x.shape[-1] // n
    cut = [torch.from_numpy(a[..., rank * b:(rank + 1) * b].copy())
           for a in (x, w, c)]
    xb, wb = (a.requires_grad_(True) for a in cut[:2])
    y = nn.rms_norm(xb, wb, group=group)
    (y * cut[2]).sum().backward()
    return {"y": y.detach().numpy(), "dx": xb.grad.numpy(),
            "dw": wb.grad.numpy()}


def mamba_side(rank: int, n: int, group, cfg_kw, p, x, c, state) -> dict:
    """One Mamba2 layer on a (1, 1, n) mesh, its leaves cut under
    SERVE_RESIDENT_RULES: ``mamba2_block`` over x differentiated through
    sum(y * c) (y, and every gradient gathered whole over 'model'), and
    one ``mamba2_decode`` step from ``state`` (the rank's heads of it
    where they split): its output and the new state gathered whole."""
    import types

    import torch

    from repro_torch.dist import sharding
    from repro_torch.models import mamba2

    mesh = _mesh((1, 1, n))
    cfg = _cfg("zamba2-7b").scaled(**cfg_kw)
    specs = mamba2.mamba2_specs(cfg)
    shard = sharding.param_shardings(specs, mesh,
                                     sharding.SERVE_RESIDENT_RULES)
    local = {k: sharding.shard_tensor(torch.from_numpy(v), shard[k].spec,
                                      mesh).requires_grad_(True)
             for k, v in p.items()}
    lp = types.SimpleNamespace(**local)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = mamba2.mamba2_block(cfg, lp, xt)
    (y * torch.from_numpy(c)).sum().backward()
    grads = {k: sharding.unshard(torch.zeros_like(t) if t.grad is None
                                 else t.grad, shard[k].spec, mesh).numpy()
             for k, t in local.items()}  # norm_w is never read
    H = mamba2.heads(cfg)[0]
    heads_split = H % n == 0
    s = torch.from_numpy(state)
    if heads_split:
        s = s.narrow(1, rank * (H // n), H // n).contiguous()
    with torch.no_grad():
        yd, s_new = mamba2.mamba2_decode(cfg, lp, xt[:, :1].detach(), s)
    if heads_split:
        s_new = sharding.unshard(s_new, sharding.P(None, "model"), mesh)
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(), "grads": grads,
            "decode_y": yd.numpy(), "decode_state": s_new.numpy(),
            "local_shapes": {k: tuple(t.shape) for k, t in local.items()}}
