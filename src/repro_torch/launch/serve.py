"""Serving launcher: a thin loop over the continuous-batching engine
(the port of ``repro.launch.serve``).

Requests stream through a queue into a fixed pool of KV-cache slots
(``repro_torch.serve.ServeEngine``); slots are freed on EOS / per-request
max-gen / cache capacity and refilled at once.  ``--naive`` runs the
lockstep oracle loop (``repro_torch.serve.oracle``) instead.

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b      # on the card
  python -m repro_torch.launch.serve --arch qwen3-32b --smoke --device cpu \\
      --requests 8 --slots 4 --prompt-len 16 --gen 8
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b --smoke \\
      --device cpu --naive     # llava: the naive loop, with the patch stub
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke --device cpu
  python -m repro_torch.launch.serve --arch zamba2-7b --smoke --device cpu

Weights are random (the reference's init law, seed 0); prompts come
from ``numpy.random.default_rng``.  The model is built layer by layer in
the config's compute dtype (``registry.init_model``), which gives the
values the reference's cast at every use gives (rwkv6: the values it
gives on parameters cast to that dtype, as its training casts them) and
keeps the peak near the weights in that dtype (phi3.5-moe's 32 layers
are 78 GiB in bf16).  Under a launcher that sets ``RANK`` / ``WORLD_SIZE``
the engine runs on a ``make_host_mesh(data=world, model=1)`` mesh, as the
reference's launcher does: weights resident on every rank
(SERVE_RESIDENT_RULES), the slots split over the ranks.
"""
from __future__ import annotations

import argparse
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.data import synthetic
from repro_torch.launch.mesh import launcher_mesh
from repro_torch.models import registry
from repro_torch.serve import ServeEngine, naive_generate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(engine: ServeEngine, model, requests, *, log=lambda *_: None):
    """Pump ``requests`` (iterable of (rid, tokens, max_gen)) through the
    slot pool.  Returns (outputs {rid: [token ids]}, stats): steps,
    tokens out, wall seconds, mean occupancy, tokens/s, and the time
    split — ``prefill_s`` over ``prefills`` prompts of
    ``prompt_tokens`` tokens (prefill + insert, ended by reading the
    first token), ``step_ms`` per decode step (ended by reading the
    tokens)."""
    state = engine.init_state()
    free = list(range(engine.ecfg.max_slots))
    pending = deque(requests)
    outputs: dict = {}
    slot_rid: dict = {}
    steps = 0
    occ_sum = 0.0
    tokens_out = 0
    prefills = prompt_tokens = 0
    prefill_s = 0.0
    step_ms = []
    _sync(engine.device)
    t0 = time.perf_counter()
    while pending or slot_rid:
        while free and pending:
            rid, toks, max_gen = pending.popleft()
            tp = time.perf_counter()
            _, prefix = engine.prefill(model, toks)
            slot = free.pop()
            state = engine.insert(state, prefix, slot, max_gen=max_gen)
            outputs[rid] = [int(prefix.next_token)]
            prefill_s += time.perf_counter() - tp
            prefills += 1
            prompt_tokens += prefix.length
            tokens_out += 1
            if max_gen <= 1:  # satisfied by the prefill token alone
                free.append(slot)
                log(f"[serve] rid={rid} done at insert (max_gen=1)")
            else:
                slot_rid[slot] = rid
        if not slot_rid:
            continue
        occ_sum += len(slot_rid) / engine.ecfg.max_slots
        ts = time.perf_counter()
        state, toks, done = engine.generate_step(model, state)
        toks_h, done_h = toks.cpu().numpy(), done.cpu().numpy()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        steps += 1
        for slot, rid in list(slot_rid.items()):
            outputs[rid].append(int(toks_h[slot]))
            tokens_out += 1
            if done_h[slot]:
                del slot_rid[slot]
                free.append(slot)
                log(f"[serve] rid={rid} done ({len(outputs[rid])} tokens), "
                    f"slot {slot} freed")
    dt = time.perf_counter() - t0
    return outputs, {
        "steps": steps,
        "tokens_out": tokens_out,
        "wall_s": dt,
        "mean_occupancy": occ_sum / steps if steps else 0.0,
        "tokens_per_s": tokens_out / dt if dt > 0 else 0.0,
        "prefills": prefills,
        "prompt_tokens": prompt_tokens,
        "prefill_s": prefill_s,
        "step_ms": step_ms,
    }


def build_model(cfg, seed: int, device, mesh=None, rules=None):
    """Random weights with the reference's init law from a generator on
    ``device`` seeded with ``seed``, in the compute dtype; on a ``mesh``,
    this rank's blocks of them under ``rules`` (default
    SERVE_RESIDENT_RULES)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return registry.init_model(cfg, gen, dev, mesh, rules)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8,
                    help="tokens per request (prefill token included)")
    ap.add_argument("--eos", type=int, default=None,
                    help="token id treated as EOS (frees the slot early)")
    ap.add_argument("--naive", action="store_true",
                    help="run the lockstep oracle loop instead")
    ap.add_argument("--batch", type=int, default=2,
                    help="(--naive only) lockstep batch size")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.smoke:
        cfg = cfg.scaled(compute_dtype="float32")
    device = resolve_device(args.device)
    mesh, device = launcher_mesh(device)
    if mesh is not None and mesh.rank == 0:
        print(f"[serve] mesh {mesh.shape} over {dist.get_backend()} on "
              f"{device}")
    model = build_model(cfg, 0, device, mesh)
    P = args.prompt_len
    rng = np.random.default_rng(1)

    if args.naive:
        B = args.batch
        prompts = synthetic.with_frontend_stubs({"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(B, P), dtype=np.int32),
            device=device)}, cfg)
        t0 = time.perf_counter()
        toks = naive_generate(cfg, model, prompts, args.gen)
        toks = toks.cpu()
        dt = time.perf_counter() - t0
        print(f"[serve] naive {B}x{args.gen} tokens in {dt:.2f}s "
              f"({B * args.gen / dt:.1f} tok/s)")
        print("[serve] sample token ids:", toks[0].tolist())
        return

    engine = ServeEngine(cfg, max_slots=args.slots, max_prefill_len=P,
                         max_gen_len=args.gen, eos_id=args.eos,
                         device=device)
    requests = [
        (r, rng.integers(0, cfg.vocab, size=(P,), dtype=np.int32), args.gen)
        for r in range(args.requests)
    ]
    log = print if mesh is None or mesh.rank == 0 else (lambda *_: None)
    outputs, stats = drive(engine, model, requests, log=log)
    if mesh is not None:  # every rank is past its last collective
        dist.destroy_process_group()
        if mesh.rank != 0:
            return
    print(f"[serve] {args.requests} requests x {args.gen} tokens on "
          f"{args.slots} slots: {stats['tokens_out']} tokens, "
          f"{stats['steps']} steps in {stats['wall_s']:.2f}s "
          f"({stats['tokens_per_s']:.1f} tok/s, "
          f"mean occupancy {stats['mean_occupancy']:.0%})")
    print("[serve] sample token ids:", outputs[0])


if __name__ == "__main__":
    main()
