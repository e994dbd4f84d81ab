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
