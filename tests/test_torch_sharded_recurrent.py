"""The sharded path of the recurrent and encoder-decoder families on a
2 x 2 ("data", "model") mesh of four gloo processes, against the
reference's steps on four forced host devices and against the port's own
unsharded steps, at smoke size in f32: mamba2 (the SSM scan on each rank's
batch block), jamba (SSM, attention and expert layers interleaved) and
seamless (its encoder on ``enc_embeds``, cross-attention over its output).

For each: the prefill's last-position logits, one train step (through
``test_torch_sharded_steps._hold_train_step``'s bounds and its control),
a weight split over "model", and two serve steps on caches laid out by
``cache_shardings``, whose decode state differs from attention's: the SSM
cache on batch shards, and seamless's ``enc_out``.  The machinery is
``test_torch_sharded_dense.py``'s; the reference's own 2 x 2 steps run for
every family here (``test_reference_steps_ran``).
"""
import numpy as np
import pytest
import torch

from test_torch_sharded_dense import (RECURRENT, hold_prefill, hold_split,
                                      hold_train, session_runs,
                                      unsharded_decode, unsharded_prefill)
from test_torch_sharded_steps import MODEL_TOL

ARCHS = RECURRENT


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return session_runs(tmp_path_factory, "recurrent")


def test_reference_steps_ran(runs):
    """The reference's 2 x 2 prefill, train step and serve steps ran for
    every family here (none raised)."""
    _, ref, _ = runs
    assert {a: ref[a].get("error") for a in ARCHS} == dict.fromkeys(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_2x2(runs, arch):
    hold_prefill(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_2x2(runs, arch):
    hold_train(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_split_over_model(runs, arch):
    hold_split(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_2x2_on_sharded_caches(runs, arch):
    """Two serve steps on caches laid out by ``cache_shardings``: the
    logits against the reference's 2 x 2 serve steps and the port's
    unsharded ones within MODEL_TOL; every cache split over "data" (its
    batch).  Control: the second step's logits against the first's."""
    inputs, ref, port = runs
    got = port[arch]["serve"]
    for g, want, own in zip(got, ref[arch]["serve"],
                            unsharded_decode(inputs, arch)):
        np.testing.assert_allclose(g, want, atol=MODEL_TOL, rtol=MODEL_TOL)
        np.testing.assert_allclose(g, own, atol=MODEL_TOL, rtol=MODEL_TOL)
    assert not np.allclose(got[1], got[0], atol=MODEL_TOL, rtol=MODEL_TOL)
    for layer in port[arch]["cache_placements"]:
        for name, pl in layer.items():
            assert pl[0] == "Shard(dim=0)", (name, pl)


def test_seamless_encoder_reaches_the_sharded_steps(runs):
    """Control for seamless's encoder: its unsharded prefill on zeroed
    encoder frames must fail the prefill check."""
    inputs, _, port = runs
    arch = "seamless_m4t_large_v2"
    enc = torch.from_numpy(inputs["batches"][arch]["enc_embeds"])
    other = unsharded_prefill(inputs, arch, enc_embeds=torch.zeros_like(enc))
    assert not np.allclose(port[arch]["prefill"], other, atol=MODEL_TOL,
                           rtol=MODEL_TOL)
