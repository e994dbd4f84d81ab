"""Rank sides of tests/test_torch_head_split.py: each function runs in one
of the gloo ranks that ``torch_ranks.run_ranks`` spawns (several in one
spawn through ``torch_moe_mesh_ranks.jobs_side``), on a (pod, data,
model) mesh whose model axis cuts the query heads.  Imports torch and the
port only, so the ranks start without JAX."""
from __future__ import annotations

from torch_mesh_ranks import (_cfg, _engine_tokens, _gather_vocab, _mesh,
                              _tree)


def head_cfg(arch: str, cfg_kw: dict):
    """The smoke config of ``arch`` in f32 scaled by ``cfg_kw``."""
    return _cfg(arch).scaled(**cfg_kw)


def _model(cfg, params, mesh):
    from repro_torch.dist import sharding
    from repro_torch.models import registry, transformer, whisper

    tree = _tree(params)
    if mesh is not None:
        tree = sharding.shard_tree(tree, sharding.param_shardings(
            registry.param_specs(cfg), mesh, sharding.SERVE_RESIDENT_RULES))
    cls = whisper.Whisper if cfg.kind == "whisper" else \
        transformer.Transformer
    return cls(cfg, tree)


def serve_chain(cfg, model, mesh, prompt, n_steps: int):
    """Greedy ``steps.build_serve_step`` steps after the prompt's prefill
    (its last token fed first), the K / V cache kept whole and each step
    handed its block under ``registry.decode_state_shardings`` (split over
    the sequence where its rows divide the model axis, else whole):
    (tokens (B, n_steps), whether each step ran on a split cache)."""
    import torch

    from repro_torch.dist import sharding
    from repro_torch.models import parallel, registry, transformer
    from repro_torch.train import steps

    tok = torch.from_numpy(prompt)
    _, (k, v) = transformer.forward(cfg, model, tok[:, :-1])
    cache = {"k": k, "v": v}
    tok, out, split = tok[:, -1:], [], []
    B = tok.shape[0]
    for _ in range(n_steps):
        S = cache["k"].shape[2]
        sh = (registry.decode_state_shardings(cfg, mesh, B, S)
              if mesh is not None else None)
        local = cache if sh is None else sharding.shard_tree(cache, sh)
        split.append(local["k"].shape[2] < S)
        logits, (nk, nv) = steps.build_serve_step(cfg, sh)(
            model, {"tokens": tok}, local)
        cache = {"k": torch.cat([cache["k"], nk], 2),
                 "v": torch.cat([cache["v"], nv], 2)}
        tok = parallel.argmax_vocab(cfg, logits).to(torch.int32)
        out.append(tok)
    return torch.cat(out, 1).numpy(), split


def dense_side(rank: int, n: int, group, shape, arch: str, cfg_kw, params,
               tokens, prompts, n_gen: int, requests, chain_prompt,
               n_steps: int) -> dict:
    """The dense model with cut query heads on ``shape``, weights by
    SERVE_RESIDENT_RULES, in f32: the forward's logits (whole over the
    vocabulary), the engine's tokens at full occupancy, the naive loop's,
    ``launch.serve.drive``'s over ``requests``, and a ``serve_fn`` chain
    (``serve_chain``); the local shapes of the attention leaves and
    whether the engine's pool splits the sequence."""
    import torch

    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine, naive_generate

    mesh = _mesh(shape)
    cfg = head_cfg(arch, cfg_kw)
    model = _model(cfg, params, mesh)
    with torch.no_grad():
        logits, _ = transformer.forward(cfg, model, torch.from_numpy(tokens))
        logits = _gather_vocab(cfg, logits)
        chain, split = serve_chain(cfg, model, mesh, chain_prompt, n_steps)
    engine = ServeEngine(cfg, max_slots=prompts.shape[0],
                         max_prefill_len=prompts.shape[1], max_gen_len=n_gen,
                         device="cpu")
    toks = _engine_tokens(engine, model, prompts, n_gen)
    naive = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                           n_gen).numpy()
    outputs, _ = launch.drive(
        ServeEngine(cfg, max_slots=2, max_prefill_len=prompts.shape[1],
                    max_gen_len=n_gen, device="cpu"), model, requests)
    a = model.layers[0].attn
    return {"logits": logits.numpy(), "engine": toks, "naive": naive,
            "drive": outputs, "chain": chain, "chain_split": split,
            "seq_split": engine.family.seq is not None,
            "local": {k: tuple(a[k].shape) for k in ("wq", "wk", "wo")}}


def whisper_side(rank: int, n: int, group, shape, arch: str, cfg_kw,
                 params, tokens, frames, prompt, n_steps: int) -> dict:
    """whisper with cut query heads on ``shape``, weights by
    SERVE_RESIDENT_RULES, in f32: the forward's logits and a ``serve_fn``
    chain over whole caches (tokens, logits), with its caches' shapes."""
    import torch

    from repro_torch.models import registry
    from torch_family_mesh_ranks import whisper_chain

    mesh = _mesh(shape)
    cfg = head_cfg(arch, cfg_kw)
    model = _model(cfg, params, mesh)
    t, f = torch.from_numpy(prompt), torch.from_numpy(frames)
    with torch.no_grad():
        logits = _gather_vocab(cfg, registry.logits_fn(
            cfg, model, {"tokens": torch.from_numpy(tokens), "frames": f}))
        toks, chain, kv = whisper_chain(cfg, model, t, f, n_steps)
    return {"logits": logits.numpy(), "tokens": toks.numpy(),
            "chain": chain.numpy(),
            "cache": {k: tuple(v.shape) for k, v in kv.items()}}


def cut_wo_side(rank: int, n: int, group, o, wo) -> object:
    """The attention output projection (``transformer._out_proj``) in bf16
    on a (1, 1, n) mesh whose blocks of ``wo``'s rows cut heads: the whole
    output o (B, T, heads hd) narrowed to the rank's columns, times its
    rows, summed over the model axis."""
    import torch

    from repro_torch.models import parallel, transformer

    _mesh((1, 1, n))
    c = wo.shape[0] // n
    w = torch.from_numpy(wo[rank * c:(rank + 1) * c].copy())
    lp = type("Layer", (), {"attn": {"wo": w.to(torch.bfloat16)}})
    y = transformer._out_proj(lp, torch.from_numpy(o).to(torch.bfloat16),
                              parallel.tp())
    assert y.dtype == torch.bfloat16
    return y.float().numpy()
