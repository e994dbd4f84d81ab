"""The port's checkpointer against the JAX package's, on the cases of its
own tests (tests/test_checkpoint.py, tests/test_chaos.py): the commit
barrier, retention GC, the restore validation, the async checkpointer,
checkpoints that cross between the two packages in both directions, and
``FederatedAveraging.run`` killed and resumed bitwise.  States are made
with numpy from a seed."""
import gc
import os
import warnings

import numpy as np
import pytest
import torch

from helpers import ks_statistic, ks_threshold, norm_cdf
from repro.checkpoint import checkpoint as jckpt
from repro_torch.checkpoint import checkpoint
from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    CheckpointError,
    shard_keys,
)
from repro_torch.fl.federated import FederatedAveraging, FLConfig


def _state(seed=0, d=8):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(
            rng.normal(size=(d, d)).astype(np.float32)),
                   "b": [torch.from_numpy(rng.normal(size=d)),
                         rng.integers(0, 9, size=3, dtype=np.int32)]},
        "step": np.int64(seed),
    }


def _leaves(tree):
    return [np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor)
                       else leaf)
            for _, leaf in checkpoint._flatten_with_path(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _restore(d, step, like):
    return checkpoint.restore(d, step, like, device="cpu")


# ------------------------------------------------------------ basic API
def test_save_restore_roundtrip_bitwise(tmp_path):
    d = str(tmp_path)
    state = _state(1)
    checkpoint.save(d, 3, state, extra={"note": "x"})
    assert checkpoint.all_steps(d) == [3]
    assert checkpoint.read_meta(d, 3)["note"] == "x"
    assert checkpoint.read_meta(d, 3)["keys"] == [
        "params$b$0", "params$b$1", "params$w", "step"]
    with warnings.catch_warnings():
        warnings.simplefilter("error", ResourceWarning)
        restored = _restore(d, 3, _state(99))
        gc.collect()
    _assert_trees_equal(state, restored)
    assert all(isinstance(x, torch.Tensor)
               for _, x in checkpoint._flatten_with_path(restored))


def test_restore_runs_on_the_card_unless_told():
    """Restore places leaves on the port's device: CUDA by default, which
    raises here rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default places leaves on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore("/nonexistent", 1, {})


def test_shard_keys_partition_disjoint_cover():
    keys = [f"k{i}" for i in range(11)]
    parts = [shard_keys(keys, i, 3) for i in range(3)]
    assert parts == [jckpt.shard_keys(keys, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == sorted(keys)
    for i in range(3):
        for j in range(i + 1, 3):
            assert not set(parts[i]) & set(parts[j])


# ----------------------------------------------------- commit barrier
def test_kill_between_npz_write_and_commit(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, _state(1))
    checkpoint.save(d, 2, _state(2), shard_index=0, num_shards=2)
    step2 = os.path.join(d, "step_00000002")
    assert os.path.exists(os.path.join(step2, "arrays-00000-of-00002.npz"))
    assert not os.path.exists(os.path.join(step2, "meta.json"))
    assert checkpoint.latest_step(d) == 1
    _assert_trees_equal(_state(1), _restore(d, 1, _state(0)))
    with pytest.raises(CheckpointError, match="not committed"):
        checkpoint.read_meta(d, 2)


def test_multishard_commit_barrier_then_commit(tmp_path):
    d = str(tmp_path)
    state = _state(4)
    checkpoint.save(d, 7, state, shard_index=1, num_shards=2)
    assert checkpoint.latest_step(d) is None
    checkpoint.save(d, 7, state, shard_index=0, num_shards=2)
    assert checkpoint.latest_step(d) == 7
    assert checkpoint.read_meta(d, 7)["num_shards"] == 2
    _assert_trees_equal(state, _restore(d, 7, _state(0)))


def test_gc_reaps_stale_partials_never_newest_committed(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        checkpoint.save(d, s, _state(s))
    checkpoint.save(d, 0, _state(0), shard_index=0, num_shards=2)
    checkpoint.save(d, 9, _state(9), shard_index=0, num_shards=2)
    deleted = checkpoint.garbage_collect(d, keep_last_k=1)
    assert sorted(deleted) == [0, 1, 2]
    assert checkpoint.all_steps(d) == [3]
    assert os.path.isdir(os.path.join(d, "step_00000009"))
    checkpoint.save(d, 2, _state(2), shard_index=0, num_shards=2)
    assert checkpoint.garbage_collect(d, keep_last_k=1, protect=(2,)) == []
    assert os.path.isdir(os.path.join(d, "step_00000002"))


def test_restore_rejects_foreign_target(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, _state(1))
    with pytest.raises(CheckpointError, match="does not match the restore"):
        _restore(d, 1, {"other": np.zeros(3)})


def test_restore_rejects_tampered_shard(tmp_path):
    d = str(tmp_path)
    state = _state(1)
    checkpoint.save(d, 1, state)
    shard = os.path.join(d, "step_00000001", "arrays-00000-of-00001.npz")
    with np.load(shard) as npz:
        arrays = {k: npz[k] for k in npz.files}
    arrays.pop(sorted(arrays)[0])
    arrays["rogue"] = np.zeros(2)
    with open(shard, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(CheckpointError, match="inconsistent with its meta"):
        _restore(d, 1, state)


def test_bf16_leaf_refused(tmp_path):
    with pytest.raises(TypeError, match="bf16"):
        checkpoint.save(str(tmp_path), 1,
                        {"w": torch.zeros(2, dtype=torch.bfloat16)})


# -------------------------------------------------- async checkpointer
def test_async_checkpointer_retention_and_roundtrip(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep_last_k=2)
    states = {s: _state(s) for s in range(1, 6)}
    for s in range(1, 6):
        ck.save(s, states[s])
    ck.wait(timeout=30.0)
    assert checkpoint.all_steps(d) == [4, 5]
    _assert_trees_equal(states[5], _restore(d, 5, _state(0)))
    ck.close()


def test_async_checkpointer_sharded_commit(tmp_path):
    d = str(tmp_path)
    state = _state(3)
    hosts = [AsyncCheckpointer(d, keep_last_k=None, shard_index=i,
                               num_shards=2) for i in range(2)]
    hosts[0].save(1, state)
    hosts[0].wait(timeout=30.0)
    assert checkpoint.latest_step(d) is None
    hosts[1].save(1, state)
    hosts[1].wait(timeout=30.0)
    assert checkpoint.latest_step(d) == 1
    _assert_trees_equal(state, _restore(d, 1, _state(0)))
    for h in hosts:
        h.close()


def test_async_checkpointer_surfaces_worker_failure(tmp_path):
    """A failed background save raises on the next wait."""
    d = str(tmp_path)
    ck = AsyncCheckpointer(d)
    ck.save(1, {"w": np.zeros(2)})
    ck.wait(timeout=30.0)
    with open(os.path.join(d, "step_00000002"), "w") as f:
        f.write("not a directory")  # the step's directory cannot be made
    try:
        ck.save(2, {"w": np.ones(2)})
        with pytest.raises(CheckpointError, match="async checkpoint"):
            ck.wait(timeout=30.0)
    finally:
        ck.close()
    assert checkpoint.latest_step(d) == 1


# ------------------------------------------------- across the packages
def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                       "b": [rng.normal(size=4),
                             rng.integers(0, 9, 3, dtype=np.int32)]},
            "round": np.int64(seed)}


@pytest.mark.parametrize("num_shards", [1, 2])
def test_reference_checkpoint_restores_in_the_port(tmp_path, num_shards):
    d = str(tmp_path)
    state = _numpy_state(5)
    for i in range(num_shards):
        jckpt.save(d, 4, state, shard_index=i, num_shards=num_shards)
    assert checkpoint.latest_step(d) == 4
    restored = _restore(d, 4, _numpy_state(0))
    _assert_trees_equal(state, restored)
    assert int(restored["round"]) == 5


@pytest.mark.parametrize("num_shards", [1, 2])
def test_port_checkpoint_restores_in_the_reference(tmp_path, num_shards):
    d = str(tmp_path)
    state = _state(6)
    for i in range(num_shards):
        checkpoint.save(d, 2, state, shard_index=i, num_shards=num_shards)
    assert jckpt.latest_step(d) == 2
    assert jckpt.read_meta(d, 2) == checkpoint.read_meta(d, 2)
    like = {"params": {"w": np.zeros(1), "b": [np.zeros(1), np.zeros(1)]},
            "step": np.int64(0)}
    restored = jckpt.restore(d, 2, like)
    # values equal; the JAX package itself casts 64-bit leaves to 32 bits
    # (jax's default), the files keep them
    for want, got in zip(_leaves(state), jckpt._flatten(restored).values()):
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    _assert_trees_equal(state, checkpoint.restore(d, 2, like, device="cpu"))


# --------------------------------------------- kill-and-resume (sync FL)
N, D, SEED = 4, 32, 3


def _fl(**kw):
    base = dict(n_clients=N, mechanism="aggregate_gaussian", sigma=1e-3,
                clip=2.0, cohort_fraction=1.0, straggler_fraction=0.0,
                lr=0.3, seed=SEED)
    base.update(kw)
    return FLConfig(**base)


@pytest.mark.parametrize("mechanism", ["aggregate_gaussian",
                                       "individual_shifted"])
def test_sync_loop_kill_and_resume_bitwise(tmp_path, mechanism):
    """FederatedAveraging.run with checkpointing: stop after 3 rounds,
    resume, and land bitwise on the uninterrupted 6-round params."""
    targets = torch.from_numpy(np.asarray(
        np.random.default_rng(0).normal(size=(N, D)), np.float32))

    def grad(params, cid, rnd):
        return {"w": params["w"] - targets[cid]}

    fa = FederatedAveraging(_fl(lr=0.5, mechanism=mechanism), grad,
                            device="cpu")
    p0 = {"w": torch.zeros(D)}
    ref, _ = fa.run(p0, 6)
    ck = str(tmp_path / "ck")
    fa.run(p0, 3, checkpoint_dir=ck, checkpoint_every=1)
    assert checkpoint.all_steps(ck) == [1, 2, 3]
    resumed, info = fa.run(p0, 6, checkpoint_dir=ck, resume=True)
    assert info["start_round"] == 3
    assert torch.equal(ref["w"], resumed["w"])
    assert checkpoint.all_steps(ck) == [4, 5, 6]  # keep_last_k = 3


def test_resumed_run_preserves_exact_error_law(tmp_path):
    """With zero client updates the decoded mean update is the exact
    aggregate noise, so the rounds after a resume stay N(0, sigma^2)."""
    d, sigma, rounds = 512, 1e-3, 8
    fl = _fl(sigma=sigma, clip=1.0, lr=1.0, seed=11)
    fa = FederatedAveraging(fl, lambda p, c, r: {"w": torch.zeros(d)},
                            device="cpu")
    p0 = {"w": torch.zeros(d)}
    ck = str(tmp_path / "ck")
    fa.run(p0, 3, checkpoint_dir=ck, checkpoint_every=1)
    state = _restore(ck, 3, {"params": p0, "round": np.int64(0)})
    params, start = state["params"], int(state["round"])
    assert start == 3
    noise = []
    for rnd in range(start, rounds):
        new, _ = fa.round(params, rnd)
        noise.append(((params["w"] - new["w"]) / fl.lr).numpy())
        params = new
    noise = np.concatenate(noise)
    assert ks_statistic(noise, lambda x: norm_cdf(x, sigma)) <= \
        ks_threshold(noise.size)
