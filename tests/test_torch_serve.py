"""The port's serve path against the JAX package: the port's
``ServeEngine`` emits the same tokens as the reference's
``naive_generate`` on the same (carried-across) weights; and, within the
port, engine against oracle, the slot lifecycle, bitwise freezing of
inactive slots, the refused families and prompts, ``drive``'s stats and
the CUDA default of the entry points.  f32 smoke configs on the CPU; the
reference runs on a one-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import meshctx
from repro.models import nn as jnn
from repro.models import registry as jregistry
from repro.serve import naive_generate as j_naive_generate
from repro_torch import configs
from repro_torch.convert import transformer_from_numpy
from repro_torch.launch import serve as launch
from repro_torch.models import registry
from repro_torch.serve import ServeEngine, naive_generate


@pytest.fixture
def one_device_mesh(monkeypatch):
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         devices=jax.devices()[:1])
    monkeypatch.setattr(meshctx, "_mesh", mesh)
    return mesh


def _cfg(arch):
    return configs.get_smoke_config(arch).scaled(compute_dtype="float32")


def _reference(arch, seed=0):
    """(reference cfg, reference params, port cfg, port model)."""
    cfg_j = jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32")
    params = jnn.init_params(jregistry.param_specs(cfg_j),
                             jax.random.PRNGKey(seed))
    model = transformer_from_numpy(_cfg(arch),
                                   jax.tree.map(np.asarray, params), "cpu")
    return cfg_j, params, _cfg(arch), model


def _model(arch, seed=0):
    cfg = _cfg(arch)
    return cfg, launch.build_model(cfg, seed, "cpu")


def _prompts(cfg, n, p, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(n, p),
                                                dtype=np.int32)


def _engine_tokens(engine, model, prompts, n_tokens):
    """Full occupancy: insert every prompt, then step.  (N, n_tokens)."""
    state = engine.init_state()
    for i in range(prompts.shape[0]):
        _, prefix = engine.prefill(model, prompts[i])
        state = engine.insert(state, prefix, i, max_gen=n_tokens)
    outs = [state["tokens"].clone()]
    for _ in range(n_tokens - 1):
        state, tok, _ = engine.generate_step(model, state)
        outs.append(tok)
    return torch.stack(outs, dim=1).numpy(), state


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "starcoder2-3b",
                                  "qwen3-32b"])
def test_engine_tokens_equal_reference_naive_generate(arch, one_device_mesh):
    """The port's engine (plain flash attention for the prompt, slot-pool
    decode) against the reference's naive loop, token for token."""
    cfg_j, params, cfg, model = _reference(arch)
    N, P, G = 2, 6, 8
    prompts = _prompts(cfg, N, P, seed=1)
    want = np.asarray(j_naive_generate(
        cfg_j, params, {"tokens": jnp.asarray(prompts)}, G))
    engine = ServeEngine(cfg, max_slots=N, max_prefill_len=P, max_gen_len=G,
                         device="cpu")
    got, state = _engine_tokens(engine, model, prompts, G)
    np.testing.assert_array_equal(got, want)
    assert not bool(state["active"].any())  # all hit max_gen


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "minitron-4b"])
def test_engine_equals_port_oracle(arch):
    cfg, model = _model(arch)
    N, P, G = 3, 7, 6
    prompts = _prompts(cfg, N, P, seed=2)
    want = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                          G).numpy()
    engine = ServeEngine(cfg, max_slots=N, max_prefill_len=P, max_gen_len=G,
                         device="cpu")
    got, _ = _engine_tokens(engine, model, prompts, G)
    np.testing.assert_array_equal(got, want)


# the moe kind: phi3.5-moe's smoke config and dbrx's at its top 4
MOE = [("phi3.5-moe-42b-a6.6b", {}), ("dbrx-132b", {"top_k": 4})]


def _moe_reference(arch, kw, seed=0):
    cfg_j = jconfigs.get_smoke_config(arch).scaled(compute_dtype="float32",
                                                   **kw)
    cfg = _cfg(arch).scaled(**kw)
    params = jnn.init_params(jregistry.param_specs(cfg_j),
                             jax.random.PRNGKey(seed))
    model = transformer_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   "cpu")
    return cfg_j, params, cfg, model


@pytest.mark.parametrize("arch,kw", MOE)
def test_moe_engine_tokens_equal_reference_engine(arch, kw, one_device_mesh):
    """The moe engine (each prompt's prefill one call, each decode step
    one call over the slots, so the calls route the same tokens on both
    sides) against the reference's ``ServeEngine``, token for token, at
    full occupancy and with one slot finishing early."""
    from repro.serve import ServeEngine as JServeEngine

    cfg_j, params, cfg, model = _moe_reference(arch, kw)
    N, P, G = 3, 7, 8
    prompts = _prompts(cfg, N, P, seed=11)
    jeng = JServeEngine(cfg_j, max_slots=N, max_prefill_len=P, max_gen_len=G)
    jstate = jeng.init_state()
    teng = ServeEngine(cfg, max_slots=N, max_prefill_len=P, max_gen_len=G,
                       device="cpu")
    tstate = teng.init_state()
    for i in range(N):
        _, jp = jeng.prefill(params, prompts[i])
        jstate = jeng.insert(jstate, jp, i, max_gen=4 if i == 1 else G)
        _, tp = teng.prefill(model, prompts[i])
        tstate = teng.insert(tstate, tp, i, max_gen=4 if i == 1 else G)
    want, got = [np.asarray(jstate["tokens"])], [tstate["tokens"].numpy()]
    for _ in range(G - 1):
        jstate, jt, _ = jeng.generate_step(params, jstate)
        tstate, tt, _ = teng.generate_step(model, tstate)
        want.append(np.asarray(jt))
        got.append(tt.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    np.testing.assert_array_equal(tstate["lengths"].numpy(),
                                  np.asarray(jstate["lengths"]))


@pytest.mark.parametrize("arch,kw", MOE)
def test_moe_naive_loop_equals_reference(arch, kw, one_device_mesh):
    """The naive loop serves moe: token for token the reference's."""
    cfg_j, params, cfg, model = _moe_reference(arch, kw)
    prompts = _prompts(cfg, 2, 6, seed=12)
    want = np.asarray(j_naive_generate(
        cfg_j, params, {"tokens": jnp.asarray(prompts)}, 8))
    got = naive_generate(cfg, model, {"tokens": torch.from_numpy(prompts)},
                         8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_engine_equals_port_oracle_one_request_per_call():
    """Within the port, with one request per call (a B = 1 prefill on
    both sides; a decode step of 2 slots or 1 row cannot drop a choice):
    the moe engine's tokens equal the naive loop's, request by request."""
    cfg, model = _model("dbrx-132b")
    P, G = 7, 6
    prompts = _prompts(cfg, 2, P, seed=13)
    engine = ServeEngine(cfg, max_slots=2, max_prefill_len=P, max_gen_len=G,
                         device="cpu")
    got, _ = _engine_tokens(engine, model, prompts, G)
    for i in range(2):
        want = naive_generate(cfg, model, {"tokens": torch.from_numpy(
            prompts[i:i + 1])}, G).numpy()
        np.testing.assert_array_equal(got[i:i + 1], want)


def test_oracle_matches_full_forward():
    """Teacher forcing: the prompt plus the generated prefix through the
    full (flash attention) forward re-derives the oracle's greedy
    choices, made with the decode attention."""
    cfg, model = _model("qwen1.5-0.5b")
    P, G = 6, 6
    prompts = torch.from_numpy(_prompts(cfg, 2, P, seed=3))
    gen = naive_generate(cfg, model, {"tokens": prompts}, G)
    full = torch.cat([prompts, gen[:, :-1]], dim=1)
    logits = registry.logits_fn(cfg, model, {"tokens": full})
    redo = torch.clamp(torch.argmax(logits[:, P - 1:], dim=-1), 0,
                       cfg.vocab - 1)
    np.testing.assert_array_equal(gen.numpy(), redo.numpy())


def test_slot_lifecycle_mixed_lengths():
    """Requests of different max_gen finish at different steps; a freed
    slot is re-inserted into mid-flight; every request's tokens equal its
    solo run (slot isolation)."""
    cfg, model = _model("qwen1.5-0.5b")
    P = 5
    prompts = _prompts(cfg, 3, P, seed=4)
    eng = ServeEngine(cfg, max_slots=2, max_prefill_len=P, max_gen_len=8,
                      device="cpu")
    state = eng.init_state()
    assert eng.occupancy(state) == 0.0 and eng.free_slots(state) == [0, 1]

    _, pa = eng.prefill(model, prompts[0])
    state = eng.insert(state, pa, 0, max_gen=3)
    _, pb = eng.prefill(model, prompts[1])
    state = eng.insert(state, pb, 1, max_gen=6)
    assert eng.occupancy(state) == 1.0 and eng.free_slots(state) == []
    out_a, out_b = [int(pa.next_token)], [int(pb.next_token)]

    state, tok, done = eng.generate_step(model, state)
    out_a.append(int(tok[0]))
    out_b.append(int(tok[1]))
    assert not bool(done.any())
    state, tok, done = eng.generate_step(model, state)
    out_a.append(int(tok[0]))
    out_b.append(int(tok[1]))
    assert bool(done[0]) and not bool(done[1])  # A hit max_gen = 3
    assert eng.free_slots(state) == [0] and eng.occupancy(state) == 0.5

    _, pc = eng.prefill(model, prompts[2])
    state = eng.insert(state, pc, 0, max_gen=4)
    assert eng.occupancy(state) == 1.0
    out_c = [int(pc.next_token)]
    for i in range(3):
        state, tok, done = eng.generate_step(model, state)
        out_c.append(int(tok[0]))
        out_b.append(int(tok[1]))
        assert bool(done.any()) == (i == 2)
    assert bool(done[0]) and bool(done[1])  # C (gen 4) and B (gen 6)
    assert eng.free_slots(state) == [0, 1]

    for out, row, g in ((out_a, 0, 3), (out_b, 1, 6), (out_c, 2, 4)):
        solo = naive_generate(
            cfg, model, {"tokens": torch.from_numpy(prompts[row:row + 1])}, g)
        np.testing.assert_array_equal(np.asarray(out), solo[0].numpy())


def test_inactive_slots_frozen_bitwise():
    """A step over a fully inactive pool leaves the cache (updated in
    place) and every bookkeeping tensor bitwise unchanged."""
    cfg, model = _model("qwen1.5-0.5b")
    N, P = 2, 4
    prompts = _prompts(cfg, N, P, seed=5)
    eng = ServeEngine(cfg, max_slots=N, max_prefill_len=P, max_gen_len=8,
                      device="cpu")
    state = eng.init_state()
    for i in range(N):
        _, prefix = eng.prefill(model, prompts[i])
        state = eng.insert(state, prefix, i, max_gen=8)
    state, _, _ = eng.generate_step(model, state)  # one real step first

    frozen = dict(state, active=torch.zeros((N,), dtype=torch.bool))
    before = {k: v.clone() for k, v in frozen["cache"].items()}
    stepped, tok, done = eng.generate_step(model, frozen)
    assert not bool(done.any())
    for k in before:
        assert torch.equal(stepped["cache"][k], before[k]), k
    for k in ("tokens", "lengths", "gen", "max_gen", "active"):
        assert torch.equal(stepped[k], frozen[k]), k
    assert torch.equal(tok, frozen["tokens"])


def test_partly_active_pool_writes_only_active_rows():
    """With one of two slots active, the step writes exactly one cache
    row per layer: the active slot's, at its length."""
    cfg, model = _model("qwen1.5-0.5b")
    prompts = _prompts(cfg, 2, 4, seed=6)
    eng = ServeEngine(cfg, max_slots=2, max_prefill_len=4, max_gen_len=8,
                      device="cpu")
    state = eng.init_state()
    for i in range(2):
        _, prefix = eng.prefill(model, prompts[i])
        state = eng.insert(state, prefix, i, max_gen=8)
    state = dict(state, active=torch.tensor([False, True]))
    before = state["cache"]["k"].clone()
    eng.generate_step(model, state)
    changed = (state["cache"]["k"] != before).any(dim=(3, 4))  # (L, N, S)
    assert bool(changed[:, 1, 4].all())
    changed[:, 1, 4] = False
    assert not bool(changed.any())


@pytest.mark.parametrize("kind,match", [
    ("whisper", "frames"), ("llava", "frames")])
def test_unsupported_families_raise(kind, match):
    cfg = _cfg("qwen1.5-0.5b").scaled(kind=kind)
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(cfg, device="cpu")


def test_overlong_prompt_rejected():
    cfg, model = _model("qwen1.5-0.5b")
    eng = ServeEngine(cfg, max_slots=2, max_prefill_len=4, max_gen_len=4,
                      device="cpu")
    with pytest.raises(ValueError, match="prompt length"):
        eng.prefill(model, np.zeros(5, np.int32))
    with pytest.raises(ValueError, match="prompt length"):
        eng.prefill(model, np.zeros((1, 0), np.int32))


def test_drive_stats():
    """Five requests (one of max_gen 1, satisfied by its prefill token)
    through two slots: every request gets its budget of tokens, and the
    stats count them."""
    cfg, model = _model("starcoder2-3b")
    P, G = 6, 5
    eng = ServeEngine(cfg, max_slots=2, max_prefill_len=P, max_gen_len=G,
                      device="cpu")
    prompts = _prompts(cfg, 5, P, seed=7)
    budgets = [G, 3, 1, G, 2]
    requests = [(r, prompts[r], budgets[r]) for r in range(5)]
    outputs, stats = launch.drive(eng, model, requests)
    assert {r: len(o) for r, o in outputs.items()} == dict(enumerate(budgets))
    assert stats["tokens_out"] == sum(budgets)
    assert stats["prefills"] == 5 and stats["prompt_tokens"] == 5 * P
    assert stats["steps"] == len(stats["step_ms"]) > 0
    assert 0.0 < stats["mean_occupancy"] <= 1.0
    assert stats["tokens_per_s"] > 0 and stats["prefill_s"] > 0
    for r, out in outputs.items():
        solo = naive_generate(cfg, model,
                              {"tokens": torch.from_numpy(prompts[r:r + 1])},
                              budgets[r])
        np.testing.assert_array_equal(np.asarray(out), solo[0].numpy())


def test_entry_points_default_to_cuda():
    cfg = _cfg("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "qwen1.5-0.5b", "--smoke"])
    launch.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                 "--requests", "2", "--slots", "2", "--prompt-len", "4",
                 "--gen", "3"])
