"""Every model family's prefill and train step with the residual stream
sequence-parallel (``activation_sharding(residual_seq_parallel=True)``,
the reference dry-run's ``--sp``: the hidden states [B, S, d] split (DP,
"model", -) between blocks), on a 2 x 2 ("data", "model") mesh of four
gloo processes, four rows of 16 tokens.

Each family's last-position logits and train step are held against the
port's unsharded steps (``test_torch_sharded_dense.hold_prefill`` and
``hold_train``, each with its control), and dbrx's against the
reference's 4-device steps of the same layout.  The machinery is
``test_torch_sharded_dense.py``'s.
"""
import pytest

from repro_torch.configs import ARCHS
from test_torch_sharded_dense import (SESSION_RUNS, hold_prefill, hold_train,
                                      session_runs)

REF_ARCHS = SESSION_RUNS["residual_sp"]["ref_archs"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return session_runs(tmp_path_factory, "residual_sp")


def test_reference_steps_ran(runs):
    """The reference's 2 x 2 prefill and train step ran for dbrx in this
    layout (none raised)."""
    _, ref, _ = runs
    assert {a: ref[a].get("error") for a in REF_ARCHS} == dict.fromkeys(
        REF_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_residual_seq_parallel(runs, arch):
    hold_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_residual_seq_parallel(runs, arch):
    hold_train(runs, arch)
