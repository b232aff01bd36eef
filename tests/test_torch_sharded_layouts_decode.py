"""Every model family's decode in the reference dry-run's decode_32k
layout, on a 2 x 2 ("data", "model") mesh of four gloo processes: caches
laid out by ``cache_shardings`` (kv heads over "model" where they divide
it, else the sequence over "model"; MLA's sequence always over "model"),
the default ``activation_sharding``, four rows a step.

gemma3's one kv head and deepseek's MLA caches have their sequence split,
so each rank holds a block of the positions.  The serve steps run at
POSITIONS, which write into each block and read across both, held against
the port's unsharded steps and, for gemma3 and deepseek, the reference's
4-device steps of the same layout, within MODEL_TOL
(``test_torch_sharded_dense.hold_decode``, with its control: every write
lost).  The machinery is ``test_torch_sharded_dense.py``'s.
"""
import pytest

from repro_torch.configs import ARCHS
from test_torch_sharded_dense import (DECODE_REF_ARCHS, hold_decode,
                                      session_runs)

REF_ARCHS = DECODE_REF_ARCHS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return session_runs(tmp_path_factory, "decode_32k")


def test_reference_decode_ran(runs):
    """The reference's 2 x 2 serve steps ran for gemma3 and deepseek in
    this layout (none raised)."""
    _, ref, _ = runs
    assert {a: ref[a].get("error") for a in REF_ARCHS} == dict.fromkeys(
        REF_ARCHS)


def test_sequence_split_caches(runs):
    """gemma3's and deepseek's caches have their sequence split over
    "model" (the mesh's second axis), the others' do not: the layout this
    file holds.  Control: qwen3's kv heads divide "model"."""
    _, _, port = runs

    def seq_split(arch):
        return {pl[1] == "Shard(dim=1)" for layer in
                port[arch]["cache_placements"] for pl in layer.values()}
    assert seq_split("gemma3_1b") == seq_split("deepseek_v2_lite_16b") == {
        True}
    assert seq_split("qwen3_14b") == {False}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_32k_layout(runs, arch):
    hold_decode(runs, arch)
