"""Spawn n gloo ranks on the CPU and run one function in each: the
harness of the port's process-group tests.  Imports torch and the port
only, so a spawned rank starts without JAX."""
from __future__ import annotations

import multiprocessing
import queue
import socket


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, args, results) -> None:
    import torch
    import torch.distributed as dist

    # the ranks' tensors are small, and the test workers share the CPUs
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        out = fn(rank, n, dist.group.WORLD, *args)
        dist.barrier()
        results.put((rank, out, None))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent
        results.put((rank, None, repr(e)))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, *args, timeout: float = 300.0) -> list:
    """``fn(rank, n, group, *args)`` in ``n`` spawned gloo ranks; returns
    each rank's result, rank order.  ``fn`` must be importable by name."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, args, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(n):
            rank, out, err = results.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"rank {rank} failed: {err}")
            got[rank] = out
    except queue.Empty:
        raise RuntimeError(f"ranks {sorted(set(range(n)) - set(got))} "
                           f"gave no result within {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
    return [got[r] for r in range(n)]


def compress_cases(rank: int, n: int, group, cases, xs, seed: int) -> dict:
    """Rank side of tests/test_torch_dist.py: ``compress_tree`` across the
    group for each (name, CompressionConfig kwargs) case, on this rank's
    row of ``xs``; returns {name: (decoded, summed words or None)}, the
    summed words read from the int32 sum the collective returns."""
    import torch

    from repro_torch.core import prng
    from repro_torch.dist import compress as tc

    out = {}
    psum = tc._psum_msg
    for name, kw in cases:
        sums = []

        def recording(m, comp, grp):
            total = psum(m, comp, grp)
            sums.append(total.clone())
            return total

        tc._psum_msg = recording
        try:
            y = tc.compress_tree({"g": torch.from_numpy(xs[rank])},
                                 tc.CompressionConfig(**kw),
                                 prng.PRNGKey(seed), axis=group,
                                 n_clients=n, device="cpu")["g"]
        finally:
            tc._psum_msg = psum
        out[name] = (y.numpy(), sums[0].numpy() if sums else None)
    return out


def train_client_step(rank: int, n: int, group, arch: str, params, grads,
                      tokens, comp_kw: dict, seed: int) -> dict:
    """Rank side of tests/test_torch_train.py's client path, on the CPU:

    * ``aggregate``: this rank's client gradient (``grads[rank]``, the JAX
      package's, numpy leaves in its order) through
      ``compress_tree(axis=group)`` under ``fold_in(PRNGKey(seed), 0)``,
      then AdamW's ``apply`` on ``params``;
    * ``step``: one whole ``build_train_step(group=)`` step from
      ``params`` on the global batch ``tokens``.
    Returns numpy leaves of the aggregate, its summed words and both
    steps' params, and the step's loss."""
    import torch

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.dist import compress as tc
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.train import steps

    torch.set_num_threads(1)
    cfg = configs.get_smoke_config(arch).scaled(compute_dtype="float32")
    comp = tc.CompressionConfig(**comp_kw)
    p = _tree(params)
    _, rebuild = tc._flatten(p)
    g = rebuild([torch.from_numpy(x.copy()) for x in grads[rank]])
    words = []
    psum = tc._psum_msg

    def recording(m, comp, grp):
        words.append(psum(m, comp, grp).clone())
        return words[-1]

    tc._psum_msg = recording
    try:
        agg = tc.compress_tree(g, comp, prng.fold_in(prng.PRNGKey(seed), 0),
                               axis=group, n_clients=n, device="cpu")
    finally:
        tc._psum_msg = psum
    opt = get_optimizer("adamw", 3e-4)
    new, _ = opt.apply(agg, opt.init(p), p)
    tcfg = steps.TrainConfig(optimizer="adamw", lr=3e-4, compression=comp)
    state = {"params": p, "opt_state": opt.init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = steps.build_train_step(cfg, tcfg, group)(
        state, {"tokens": torch.from_numpy(tokens)}, seed)

    def leaves(tree):
        return [x.numpy() for x in tc._flatten(tree)[0]]

    return {"aggregate": leaves(agg), "params": leaves(new),
            "words": [w.numpy() for w in words],
            "step_params": leaves(state["params"]),
            "step_loss": float(m["loss"]), "cohort": m["cohort"]}


def _tree(node):
    """numpy tree -> torch tree (dicts only, as a parameter tree)."""
    import torch

    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    return torch.from_numpy(node.copy())
