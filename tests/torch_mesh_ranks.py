"""Rank sides of tests/test_torch_mesh.py: each function runs in one of
the gloo ranks that ``torch_ranks.run_ranks`` spawns, builds the
(pod, data, model) mesh over them and drives one path of the port on
it.  Imports torch and the port only, so the ranks start without JAX."""
from __future__ import annotations

import hashlib


def _mesh(shape):
    from repro_torch.dist import meshctx

    mesh = meshctx.make_mesh(shape)
    meshctx.set_mesh(mesh)
    return mesh


def _cfg(arch: str, kv_heads=None):
    from repro_torch import configs

    cfg = configs.get_smoke_config(arch).scaled(compute_dtype="float32")
    return cfg if kv_heads is None else cfg.scaled(n_kv_heads=kv_heads)


def _tree(node):
    import torch

    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(node.copy())


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _gather_vocab(cfg, logits):
    """Logits whole over the vocabulary (the blocks gathered over model)."""
    from repro_torch.dist import collectives as coll
    from repro_torch.models import parallel

    return coll.all_gather(logits, -1, parallel.vocab_group(cfg, logits))


def _engine_tokens(engine, model, prompts, n_tokens):
    """Full occupancy, as tests/test_torch_serve.py's helper."""
    import torch

    state = engine.init_state()
    for i in range(prompts.shape[0]):
        _, prefix = engine.prefill(model, prompts[i])
        state = engine.insert(state, prefix, i, max_gen=n_tokens)
    outs = [state["tokens"].clone()]
    for _ in range(n_tokens - 1):
        state, tok, _ = engine.generate_step(model, state)
        outs.append(tok)
    return torch.stack(outs, dim=1).numpy()


def serve_side(rank: int, n: int, group, shape, arch: str, kv_heads,
               params, tokens, prompts, n_gen: int, requests) -> dict:
    """The tensor-parallel model on ``shape``: the forward's logits in f32
    and in bf16 (gathered over the vocabulary), the engine's tokens at full occupancy
    and over ``requests`` through ``launch.serve.drive``, the naive loop's
    tokens, and each path's KV layout.  Weights: the reference's, each
    rank cutting its blocks under SERVE_RESIDENT_RULES."""
    import torch

    from repro_torch.dist import meshctx, sharding
    from repro_torch.launch import serve as launch
    from repro_torch.models import registry, transformer
    from repro_torch.serve import ServeEngine, naive_generate

    mesh = _mesh(shape)
    cfg = _cfg(arch, kv_heads)
    shard = sharding.param_shardings(registry.param_specs(cfg), mesh,
                                     sharding.SERVE_RESIDENT_RULES)
    model = transformer.Transformer(
        cfg, sharding.shard_tree(_tree(params), shard))
    with torch.no_grad():
        logits, (k, _) = transformer.forward(cfg, model,
                                             torch.from_numpy(tokens))
        logits = _gather_vocab(cfg, logits)
        bf16 = cfg.scaled(compute_dtype="bfloat16")
        logits_bf16 = _gather_vocab(bf16, transformer.forward(
            bf16, model, torch.from_numpy(tokens))[0].to(torch.float32))
    engine = ServeEngine(cfg, max_slots=prompts.shape[0],
                         max_prefill_len=prompts.shape[1], max_gen_len=n_gen,
                         device="cpu")
    toks = _engine_tokens(engine, model, prompts, n_gen)
    toks_rep = _engine_tokens(
        ServeEngine(cfg, max_slots=prompts.shape[0],
                    max_prefill_len=prompts.shape[1], max_gen_len=n_gen - 1,
                    device="cpu"), model, prompts, n_gen - 1)
    naive = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                           n_gen).numpy()
    outputs, _ = launch.drive(
        ServeEngine(cfg, max_slots=2, max_prefill_len=prompts.shape[1],
                    max_gen_len=n_gen, device="cpu"), model, requests)
    state = engine.init_state()
    return {"logits": logits.numpy(), "logits_bf16": logits_bf16.numpy(),
            "cache_heads": k.shape[3],
            "engine": toks, "engine_rep": toks_rep, "naive": naive,
            "drive": outputs,
            "cache_shape": tuple(state["cache"]["k"].shape),
            "seq_split": engine.family.seq is not None,
            "mesh": meshctx.get_mesh().shape}


def decode_attention_side(rank: int, n: int, group, q, kc, vc, nk, nv,
                          valid_len, window) -> object:
    """decode_attention on this rank's rows of a cache split over the
    group's ranks, the softmax combined across them."""
    import torch

    from repro_torch.models import attention

    rows = kc.shape[1] // n
    t = torch.from_numpy
    return attention.decode_attention(
        t(q), t(kc[:, rank * rows:(rank + 1) * rows]),
        t(vc[:, rank * rows:(rank + 1) * rows]), t(nk), t(nv),
        valid_len=t(valid_len), window=window, row0=rank * rows,
        group=group).numpy()


def row_parallel_side(rank: int, n: int, group, x, w) -> object:
    """``nn.row_parallel`` in bf16 on this rank's block of the inner dim
    of x @ w (x, w hold bf16 values)."""
    import torch

    from repro_torch.models import nn

    b = x.shape[1] // n
    xs = torch.from_numpy(x[:, rank * b:(rank + 1) * b].copy())
    ws = torch.from_numpy(w[rank * b:(rank + 1) * b].copy())
    y = nn.row_parallel(xs.to(torch.bfloat16), ws.to(torch.bfloat16), group)
    assert y.dtype == torch.bfloat16
    return y.float().numpy()


def argmax_side(rank: int, n: int, group, logits, vocab: int) -> object:
    """The greedy token of each row of ``logits`` held in vocab blocks over
    a (1, 1, n) mesh."""
    import torch

    from repro_torch import configs
    from repro_torch.models import parallel

    mesh = _mesh((1, 1, n))
    del mesh
    cfg = configs.get_smoke_config("qwen1.5-0.5b").scaled(vocab=vocab)
    V = logits.shape[-1] // n
    block = torch.from_numpy(logits[..., rank * V:(rank + 1) * V].copy())
    return parallel.argmax_vocab(cfg, block).numpy()


def _leaves(tree):
    from repro_torch.dist import compress

    return compress._flatten(tree)[0]


def train_side(rank: int, n: int, group, shape, arch: str, params, tokens,
               comp_kw, grad_accum: int, gather_once: bool, n_steps: int,
               seed: int, ckpt_dir, optimizer: str = "adamw",
               cfg_kw=None, frames=None) -> dict:
    """The train step on ``shape`` from the reference's params (the smoke
    config of ``arch`` in f32, scaled by ``cfg_kw``).

    Uncompressed: the mean loss and gradient (``mesh_loss_and_grads``,
    each leaf gathered whole), then ``n_steps`` steps.  Compressed (a
    ``pod`` axis): ``n_steps`` steps recording, per step, the whole-leaf
    gradients this pod hands ``compress_tree`` and the summed words.
    Returns the gathered state's digest after each step and, with
    ``ckpt_dir``, saves the last state there through the
    AsyncCheckpointer.  ``frames``: whisper's stub frame embeddings, a
    batch input beside the tokens."""
    import torch

    from repro_torch.checkpoint import checkpoint
    from repro_torch.dist import compress as dcompress
    from repro_torch.dist import sharding
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import steps

    mesh = _mesh(shape)
    cfg = _cfg(arch).scaled(**(cfg_kw or {}))
    comp = None if comp_kw is None else dcompress.CompressionConfig(**comp_kw)
    tc = steps.TrainConfig(optimizer=optimizer, lr=3e-3,
                           grad_accum=grad_accum, compression=comp,
                           gather_once=gather_once)
    sh = steps.train_state_shardings(cfg, tc, mesh)
    p = sharding.shard_tree(_tree(params), sh["params"])
    opt = get_optimizer(optimizer, 3e-3)
    state = {"params": p, "opt_state": opt.init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {"tokens": torch.from_numpy(tokens)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    out = {"rank": rank, "coords": mesh.coords(), "losses": [],
           "digests": [], "local_digest": []}

    def whole(tree, shardings):
        return [sharding.unshard(x, ns.spec, ns.mesh).numpy() for x, ns in
                zip(_leaves(tree), sharding.tree_leaves(shardings))]

    if comp is None:
        loss, g = steps.mesh_loss_and_grads(cfg, tc, mesh, p, batch,
                                            sh["params"])
        out["loss"] = float(loss)
        out["grads"] = whole(g, sh["params"])
    records = []
    if comp is not None:
        psum, compress_tree = dcompress._psum_msg, dcompress.compress_tree

        def rec_psum(m, c, grp):
            total = psum(m, c, grp)
            records[-1]["words"].append(total.clone().numpy())
            return total

        def rec_compress(grads, *a, **kw):
            records.append({"grads": [x.clone().numpy()
                                      for x in _leaves(grads)], "words": []})
            return compress_tree(grads, *a, **kw)

        dcompress._psum_msg = rec_psum
        dcompress.compress_tree = rec_compress
    try:
        step = steps.build_train_step(cfg, tc, mesh=mesh)
        for _ in range(n_steps):
            state, m = step(state, batch, seed)
            out["losses"].append(float(m["loss"]))
            out["cohort"] = int(m["cohort"])
            out["local_digest"].append(_digest(_leaves(state["params"])))
            out["digests"].append(_digest(
                [torch.from_numpy(x) for x in whole(state["params"],
                                                    sh["params"])]))
    finally:
        if comp is not None:
            dcompress._psum_msg, dcompress.compress_tree = psum, compress_tree
    out["records"] = records
    out["final"] = whole(state["params"], sh["params"])
    if ckpt_dir is not None:
        ck = checkpoint.AsyncCheckpointer(ckpt_dir, shardings=sh)
        ck.save(n_steps, state)
        ck.close()
        out["saved"] = [x for x in whole(state["params"], sh["params"])]
    return out


def restore_side(rank: int, n: int, group, shape, arch: str, comp_kw,
                 ckpt_dir, cfg_kw=None) -> dict:
    """Restore the checkpoint onto ``shape`` (placement from this mesh's
    rules, for the smoke config scaled by ``cfg_kw``) and gather every
    leaf of the state whole."""
    from repro_torch.dist import compress as dcompress
    from repro_torch.dist import sharding
    from repro_torch.train import steps

    mesh = _mesh(shape)
    cfg = _cfg(arch).scaled(**(cfg_kw or {}))
    comp = None if comp_kw is None else dcompress.CompressionConfig(**comp_kw)
    tc = steps.TrainConfig(optimizer="adamw", lr=3e-3, compression=comp)
    state, step = steps.restore_train_state(ckpt_dir, cfg, tc, device="cpu",
                                            mesh=mesh)
    sh = steps.train_state_shardings(cfg, tc, mesh)
    return {"step": step,
            "local_shapes": [tuple(x.shape) for x in _leaves(state)],
            "whole": [sharding.unshard(x, ns.spec, ns.mesh).numpy()
                      for x, ns in zip(_leaves(state), sharding.tree_leaves(sh))]}


def collectives_side(rank: int, n: int, group, blocks, weights) -> dict:
    """Each collective of ``dist.collectives`` on this rank's block of
    ``blocks`` (integer-valued f32, so every sum is exact in any order):
    the gather in f32, bf16, int32 and int64, the bf16 all-reduce, the
    reduce-scatter, and the three autograd functions' gradients against
    the rank's ``weights``."""
    import torch

    from repro_torch.dist import collectives as coll

    x = torch.from_numpy(blocks[rank].copy())
    out = {"gather": {}}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16),
                     ("i32", torch.int32), ("i64", torch.int64)):
        g = coll.all_gather(x.to(dt), 1, group)
        out["gather"][name] = (str(g.dtype), g.to(torch.float64).numpy())
    s = coll.all_reduce(x.to(torch.bfloat16), group)
    out["sum_bf16"] = (str(s.dtype), s.to(torch.float64).numpy())
    out["reduce_scatter"] = coll.reduce_scatter(x, 0, group).numpy()
    out["max"] = coll.all_reduce_max(x, group).numpy()
    w = torch.from_numpy(weights[rank].copy())
    a = x.clone().requires_grad_(True)
    (coll.gather(a, 1, group) * w).sum().backward()
    out["grad_gather"] = a.grad.numpy()
    b = x.clone().requires_grad_(True)
    (coll.copy_to(b, group) * w[:, :b.shape[1]]).sum().backward()
    out["grad_copy_to"] = b.grad.numpy()
    c = x.clone().requires_grad_(True)
    y = coll.reduce_from(c, group)
    (y * w[:, :c.shape[1]]).sum().backward()
    out["reduce_from"] = y.detach().numpy()
    out["grad_reduce_from"] = c.grad.numpy()
    return out
