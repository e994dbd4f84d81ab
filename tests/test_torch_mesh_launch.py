"""The port's launchers under a launcher's RANK / WORLD_SIZE: two CPU
processes on a (data=2, model=1) mesh against one process."""
import os
import re
import subprocess
import sys

import torch_ranks

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _launch(module, args, world):
    """``python -m module args`` as ``world`` ranks of a launcher (RANK,
    WORLD_SIZE, MASTER_ADDR / PORT), or one plain process for world 0:
    each process's (returncode, stdout, stderr)."""
    port = torch_ranks.free_port()
    procs = []
    for r in range(max(world, 1)):
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        if world:
            env.update(RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *args], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out = []
    for p in procs:
        o, e = p.communicate(timeout=180)
        out.append((p.returncode, o, e))
    return out


def test_launchers_under_two_ranks(tmp_path):
    """Under RANK / WORLD_SIZE the launchers run on a (data=2, model=1)
    mesh: the train loop (FSDP, each rank its rows) reports the loss of
    the single process to 4 decimals and checkpoints whole leaves, which
    a single process resumes; the engine splits its slots over the ranks
    and emits the single process's tokens."""
    ckpt = str(tmp_path / "ckpt")
    train = ["repro_torch.launch.train", ["--arch", "qwen1.5-0.5b",
                                          "--smoke", "--device", "cpu",
                                          "--steps", "2", "--batch", "4",
                                          "--seq", "16"]]
    two = _launch(train[0], train[1] + ["--ckpt", ckpt, "--ckpt-every",
                                        "2"], 2)
    one = _launch(*train, 0)
    for rc, _, err in two + one:
        assert rc == 0, err[-2000:]
    loss = re.compile(r"step +0 loss ([0-9.]+)")
    assert loss.search(two[0][1]).group(1) == loss.search(one[0][1]).group(1)
    assert "[train] done" in two[0][1] and two[1][1] == ""
    resumed = _launch(train[0], train[1][:-4] + ["--steps", "1", "--ckpt",
                                                 ckpt, "--resume"], 0)
    assert resumed[0][0] == 0, resumed[0][2][-2000:]
    assert "resumed step 2" in resumed[0][1]
    serve = ["repro_torch.launch.serve", ["--arch", "qwen1.5-0.5b",
                                          "--smoke", "--device", "cpu",
                                          "--requests", "4", "--slots", "4",
                                          "--prompt-len", "8", "--gen", "4"]]
    two, one = _launch(*serve, 2), _launch(*serve, 0)
    for rc, _, err in two + one:
        assert rc == 0, err[-2000:]
    sample = re.compile(r"sample token ids: (.*)")
    assert sample.search(two[0][1]).group(1) == sample.search(
        one[0][1]).group(1)
    assert "4 requests x 4 tokens" in two[0][1] and two[1][1] == ""
