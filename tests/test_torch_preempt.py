"""A SIGTERM that only one rank of a sharded ``train(mesh=)`` sees (ROADMAP
fault 26, kept deviation 28): two gloo processes on a (2, 1) ("data",
"model") mesh train the qwen3-14b smoke config on the CPU; rank 1 alone
sends itself SIGTERM during step 1.  The ranks agree on the save at the
next step boundary, so both write step 2 and go on; a second run resumes
both to step 4 bitwise the straight run.

The reference saves per process with no agreement and no barrier
(``repro/launch/train.py``, ``repro/checkpoint/manager.py``); a rank that
saved alone while the other entered the next step's collectives would
wait in the save's barrier until the group's timeout.
"""
import os
import pickle
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, pickle, signal, sys
from datetime import timedelta
import torch, torch.distributed as dist
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_smoke_mesh

rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", rank=rank, world_size=2,
                        init_method=f"file://{d}/store_{sys.argv[3]}",
                        timeout=timedelta(seconds=60))
mesh = make_smoke_mesh((2, 1), ("data", "model"), device_type="cpu")
kw = dict(arch="qwen3-14b", steps=4, batch=4, seq=16, save_every=100,
          log_every=100, device="cpu", mesh=mesh)
real = T.make_train_step


def make(cfg, **k):
    step, calls = real(cfg, **k), []

    def wrapped(*args):
        calls.append(1)
        if rank == 1 and len(calls) == 2:       # during step 1, rank 1 only
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args)
    return wrapped


def state(model):
    return {k: v.full_tensor() for k, v in model.state_dict().items()}


if sys.argv[3] == "preempt":
    straight, l0 = T.train(**kw)
    T.make_train_step = make
    _, l1 = T.train(**kw, ckpt_dir=d + "/ck")
    out = {"straight": l0, "preempted": l1, "state": state(straight)}
else:
    model, l2 = T.train(**kw, ckpt_dir=d + "/ck")
    out = {"resumed": l2, "state": state(model)}
pickle.dump(out, open(f"{d}/{sys.argv[3]}_{rank}.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""


def _run(d, phase):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), d,
                               phase], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [pickle.load(open(os.path.join(d, f"{phase}_{r}.pkl"), "rb"))
            for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("preempt"))
    pre = _run(d, "preempt")
    listing = {name: sorted(os.listdir(os.path.join(d, "ck", name)))
               for name in os.listdir(os.path.join(d, "ck"))}
    return pre, listing, _run(d, "resume")


def test_one_rank_sigterm_saves_the_same_step_on_both(runs):
    """Both ranks exit 0 and one checkpoint exists, step 2, holding both
    processes' files; the preempted run's losses are the straight run's
    (saving changes nothing).  Control: the losses move over the steps."""
    pre, listing, _ = runs
    assert listing == {"step_00000002": ["extra.json", "host_0.npz",
                                         "host_1.npz", "meta.json"]}
    for r in pre:
        assert r["preempted"] == r["straight"]
        assert len(r["straight"]) == 4
    assert pre[0]["straight"][0] != pre[0]["straight"][3]


def test_preempted_run_resumes_bitwise(runs):
    """Both ranks resume from step 2 to step 4: their losses are the
    straight run's last two, and the parameters after are bitwise."""
    pre, _, res = runs
    import torch
    for p, r in zip(pre, res):
        assert r["resumed"] == p["straight"][2:]
        for k, v in r["state"].items():
            assert torch.equal(v, p["state"][k]), k
