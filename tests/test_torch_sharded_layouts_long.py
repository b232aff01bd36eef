"""Every model family's decode in the reference dry-run's long_500k
layout, on a 2 x 2 ("data", "model") mesh of four gloo processes: one row
a step, the caches by ``cache_shardings(seq_sharded=True)`` (every
attention cache's sequence over "data") and the activations by
``activation_sharding(seq_sharded=True)``.

The serve steps run at POSITIONS, which write into each rank's block of
the sequence and read across both, held against the port's unsharded
steps and, for gemma3 and deepseek, the reference's 4-device steps of the
same layout, within MODEL_TOL (``test_torch_sharded_dense.hold_decode``,
with its control: every write lost).  The machinery is
``test_torch_sharded_dense.py``'s.
"""
import pytest

from repro_torch.configs import ARCHS
from test_torch_sharded_dense import hold_decode, session_runs
from test_torch_sharded_layouts_decode import REF_ARCHS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return session_runs(tmp_path_factory, "long_500k")


def test_reference_decode_ran(runs):
    """The reference's 2 x 2 serve steps ran for gemma3 and deepseek in
    this layout (none raised)."""
    _, ref, _ = runs
    assert {a: ref[a].get("error") for a in REF_ARCHS} == dict.fromkeys(
        REF_ARCHS)


def test_sequence_split_over_data(runs):
    """Every attention cache has its sequence split over "data" (the
    mesh's first axis) and not over "model"; mamba2's SSM caches have no
    sequence.  Control: the same placements on "model" must not pass as
    split over "data"."""
    _, _, port = runs
    for arch, res in port.items():
        attn = [pl for layer in res["cache_placements"]
                for name, pl in layer.items() if name not in ("conv",
                                                              "state")]
        assert (len(attn) == 0) == (arch == "mamba2_130m"), arch
        assert all(pl[0] == "Shard(dim=1)" for pl in attn), arch
        assert not any(pl[1] == "Shard(dim=1)" for pl in attn), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_long_500k_layout(runs, arch):
    hold_decode(runs, arch)
