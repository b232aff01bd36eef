"""The port's trainer (``repro_torch.launch.train``), its data pipeline
(``repro_torch.data``) and its checkpoints of an ``OptState``, against the
JAX package's: the pipeline's batches bitwise, the step loop's losses from
the reference's initial parameters against the reference's ``train()``,
resume bitwise, and NamedTuple checkpoints both ways across packages."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.data.pipeline import DataPipeline as JPipeline
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.optim import adamw as JA

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_reference
from repro_torch.data import DataPipeline, PipelineState
from repro_torch.launch import train as train_mod
from repro_torch.optim import OptState, Q8, adamw_init, quantize_q8

# The loop's losses against the reference's train(), relative: f32 steps
# of the same model in other orders of operations (readings to 2.7e-7);
# the control (another data seed) reads 0.077.
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """``train`` installs a SIGTERM handler (its preemption path); put the
    process's own back after each test."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


# ---------------------------------------------------------------------------
# Data pipeline

def test_pipeline_batches_are_the_references():
    """Batches 0-5, after ``seek`` and by ``host_slice``, bitwise."""
    kw = dict(vocab=1000, seq_len=24, global_batch=8, seed=5)
    got, want = DataPipeline(**kw), JPipeline(**kw)
    for _ in range(6):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got.seek(2)
    want.seek(2)
    a, b = next(got), next(want)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for i in range(4):
        for k in a:
            np.testing.assert_array_equal(got.host_slice(a, i, 4)[k],
                                          want.host_slice(b, i, 4)[k])
    assert got.state.to_dict() == want.state.to_dict() == {"seed": 5,
                                                           "step": 3}
    # control: another seed's stream differs
    other = DataPipeline(vocab=1000, seq_len=24, global_batch=8, seed=6)
    other.seek(2)
    assert not np.array_equal(next(other)["tokens"], a["tokens"])


def test_pipeline_deterministic_and_resumable():
    p1 = DataPipeline(vocab=101, seq_len=16, global_batch=8, seed=3)
    batches = [next(p1) for _ in range(5)]
    p2 = DataPipeline(vocab=101, seq_len=16, global_batch=8, seed=3)
    p2.seek(3)
    np.testing.assert_array_equal(next(p2)["tokens"], batches[3]["tokens"])
    assert PipelineState.from_dict(p2.state.to_dict()).step == 4


def test_pipeline_labels_shifted():
    b = next(DataPipeline(vocab=50, seq_len=8, global_batch=2, seed=0))
    assert b["tokens"].shape == b["labels"].shape == (2, 8)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# The trainer against the reference's

TRAIN = dict(arch="qwen3-14b", smoke=True, steps=5, batch=4, seq=16,
             lr=1e-3, log_every=1)


def _carried_init(monkeypatch):
    """The port's trainer starting from the reference's initial parameters
    (``init_model(cfg, PRNGKey(seed))``)."""
    def init(cfg, seed=0, device="cuda"):
        jcfg = jtrain.get_config(TRAIN["arch"], smoke=True)
        params, _ = JT.init_model(jcfg, jax.random.PRNGKey(seed))
        return params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device=device)
    monkeypatch.setattr(train_mod.T, "init_model", init)


def test_train_loop_matches_reference_train(monkeypatch, capsys):
    """Five steps of the port's ``train`` from the reference's initial
    parameters and the same pipeline: each loss within LOSS_TOL of the
    reference ``train()``'s; the ``[train]`` lines printed.  Control: the
    port's loop on another data seed must fail.  The reference runs on a
    one-device mesh with Auto axes: the default ``jax.make_mesh`` of this
    JAX has explicit axes, which its activation constraints refuse."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    _, want = jtrain.train(**TRAIN, mesh=mesh)
    _carried_init(monkeypatch)
    _, got = train_mod.train(**TRAIN, device="cpu")
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL)
    out = capsys.readouterr().out
    assert "[train] step     4  loss" in out
    _, other = train_mod.train(**dict(TRAIN, seed=1), device="cpu")
    assert np.abs(np.asarray(other) / np.asarray(want) - 1).max() > LOSS_TOL


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_resume_is_bitwise(tmp_path, monkeypatch):
    """Four steps with Q8 moments straight through, against two steps, a
    checkpoint, and a fresh ``train`` that resumes to four: the parameters
    and the resumed losses bitwise.  Control: the same resume with the
    pipeline left at step 0 (``seek`` a no-op) must differ."""
    kw = dict(TRAIN, steps=4, quantized_opt=True, save_every=2,
              device="cpu")
    model, losses = train_mod.train(**kw, ckpt_dir=str(tmp_path / "a"))
    want = _state(model)
    train_mod.train(**dict(kw, steps=2), ckpt_dir=str(tmp_path / "b"))
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    model, resumed = train_mod.train(**kw, ckpt_dir=str(tmp_path / "b"))
    assert resumed == losses[2:]
    for k, v in _state(model).items():
        assert torch.equal(v, want[k]), k
    train_mod.train(**dict(kw, steps=2), ckpt_dir=str(tmp_path / "c"))
    monkeypatch.setattr(DataPipeline, "seek", lambda self, step: None)
    model, _ = train_mod.train(**kw, ckpt_dir=str(tmp_path / "c"))
    assert any(not torch.equal(v, want[k])
               for k, v in _state(model).items())


def test_sigterm_saves_at_the_next_step(tmp_path, monkeypatch):
    """A SIGTERM during step 1 checkpoints after it (step 2), though
    ``save_every`` is far off; the checkpoint holds the pipeline's
    position."""
    real = train_mod.make_train_step
    calls = []

    def make(cfg, **kw):
        step = real(cfg, **kw)

        def wrapped(*args):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(*args)
        return wrapped

    monkeypatch.setattr(train_mod, "make_train_step", make)
    train_mod.train(**dict(TRAIN, steps=3, save_every=100), device="cpu",
                    ckpt_dir=str(tmp_path))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 2
    cfg = configs.get_config("qwen3-14b", smoke=True)
    model = train_mod.T.init_model(cfg, 0, "cpu")
    _, extra = mgr.restore((model.state_dict(), adamw_init(model)))
    assert extra == {"step": 2, "pipeline": {"seed": 0, "step": 2}}


# ---------------------------------------------------------------------------
# Checkpoints of an OptState (f32 and Q8 leaves), across packages

def _opt_pair():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 130)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    port = OptState(step=torch.tensor(7, dtype=torch.int32),
                    m={"w": quantize_q8(torch.from_numpy(w)),
                       "b": torch.from_numpy(b)},
                    v={"w": quantize_q8(torch.from_numpy(w * w)),
                       "b": torch.from_numpy(b * b)})
    ref = JA.OptState(step=jnp.int32(7),
                      m={"w": JA.quantize_q8(jnp.asarray(w)),
                         "b": jnp.asarray(b)},
                      v={"w": JA.quantize_q8(jnp.asarray(w * w)),
                         "b": jnp.asarray(b * b)})
    return port, ref


def _zeros_like(opt):
    return OptState(
        step=torch.zeros((), dtype=torch.int32),
        m={k: Q8(torch.zeros_like(x.q), torch.zeros_like(x.scale))
           if isinstance(x, Q8) else torch.zeros_like(x)
           for k, x in opt.m.items()},
        v={k: Q8(torch.zeros_like(x.q), torch.zeros_like(x.scale))
           if isinstance(x, Q8) else torch.zeros_like(x)
           for k, x in opt.v.items()})


def _assert_same(got, want):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_namedtuple_checkpoint_round_trip(tmp_path):
    """An ``OptState`` holding f32 and ``Q8`` leaves restores as an
    ``OptState`` of ``Q8``s with the saved values."""
    port, _ = _opt_pair()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, port, extra={"step": 1})
    got, extra = mgr.restore(_zeros_like(port))
    assert type(got) is OptState and isinstance(got.m["w"], Q8)
    assert extra == {"step": 1}
    _assert_same(got, port)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_optstate_checkpoints_cross_packages(tmp_path, direction):
    """The port's checkpoint of an OptState restores in the reference's
    manager and the reference's in the port's, the same values either way
    (the leaf keys are the reference's: ``.m/['w']/.q``)."""
    port, ref = _opt_pair()
    if direction == "port_to_reference":
        CheckpointManager(str(tmp_path)).save(3, port)
        got, _ = JManager(str(tmp_path)).restore(ref)
        _assert_same(got, ref)
    else:
        JManager(str(tmp_path)).save(3, ref)
        got, _ = CheckpointManager(str(tmp_path)).restore(_zeros_like(port))
        assert type(got) is OptState
        _assert_same(got, port)


def test_training_modules_leave_jax_and_repro_out():
    """The training modules import neither JAX nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys, repro_torch.optim, repro_torch.data, "
            "repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.convert\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')))\n")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.path.abspath(src)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
