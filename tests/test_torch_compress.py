"""The port's error-feedback int8 gradient compression
(``repro_torch.optim.compress``, queue 1 item 13.6) against the
reference's ``repro.optim.compress``: bitwise on the local path, over 50
error-feedback steps, and across two ranks (gloo processes against the
reference under ``shard_map`` on two forced host devices: the reduced
gradients bitwise, the residuals to one rounding of XLA's contracted
multiply-subtract)."""
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as J

from repro_torch.optim import compress as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"ragged": rng.standard_normal(300).astype(np.float32),
            "matrix": (rng.standard_normal((3, 256)) * 1e-3).astype(np.float32),
            "wide": rng.standard_normal((2, 130)).astype(np.float32) * 50,
            "zeros": np.zeros((2, 128), np.float32)}


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_local_path_is_bitwise_the_reference():
    """Outputs and residuals, from a zero and from a nonzero residual,
    including a ragged length of 300 and an all-zero block.  Control: one
    ulp off in the residual changes some output."""
    g = _grads(0)
    ef = {k: np.zeros_like(v) for k, v in g.items()}
    for _ in range(2):
        want_o, want_e = J.compress_pod_gradients(
            {k: jnp.asarray(v) for k, v in g.items()},
            {k: jnp.asarray(v) for k, v in ef.items()})
        got_o, got_e = C.compress_pod_gradients(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in ef.items()})
        for k in g:
            assert np.array_equal(_bits(got_o[k]), _bits(want_o[k])), k
            assert np.array_equal(_bits(got_e[k]), _bits(want_e[k])), k
        ef = {k: np.array(v) for k, v in want_e.items()}
        g = _grads(1)
    assert got_o["ragged"].shape == (300,)
    off = {k: torch.from_numpy(np.nextafter(v, np.inf)) for k, v in ef.items()}
    moved, _ = C.compress_pod_gradients(
        {k: torch.from_numpy(v) for k, v in g.items()}, off)
    assert any(not np.array_equal(_bits(moved[k]), _bits(want_o[k]))
               for k in g)


def test_error_feedback_unbiased_over_steps():
    """The reference's case: a constant gradient's compressed running mean
    converges to it (within 2e-3) with error feedback, bitwise the
    reference's at every step.  Control: without the residual fed back the
    mean keeps the quantization bias."""
    rng = np.random.default_rng(1)
    g = (rng.standard_normal(256) * 1e-3
         + np.where(rng.random(256) < 0.1, 1.0, 0.0)).astype(np.float32)
    ef_t = C.ef_init({"w": torch.from_numpy(g)})
    ef_j = J.ef_init({"w": jnp.asarray(g)})
    acc, acc_plain = np.zeros(256), np.zeros(256)
    for _ in range(50):
        out_t, ef_t = C.compress_pod_gradients({"w": torch.from_numpy(g)},
                                               ef_t)
        out_j, ef_j = J.compress_pod_gradients({"w": jnp.asarray(g)}, ef_j)
        assert np.array_equal(_bits(out_t["w"]), _bits(out_j["w"]))
        acc += out_t["w"].numpy()
        plain, _ = C.compress_pod_gradients({"w": torch.from_numpy(g)},
                                            C.ef_init({"w": torch.zeros(256)}))
        acc_plain += plain["w"].numpy()
    np.testing.assert_allclose(acc / 50, g, atol=2e-3)
    assert np.abs(acc_plain / 50 - g).max() > 2e-3


REFERENCE = r'''
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.compress import compress_pod_gradients, ef_init
mesh = jax.make_mesh((2,), ('pod',))
inp = pickle.load(open(sys.argv[1], 'rb'))
out = {}
for name, (g, ef) in inp.items():
    def body(gl, el):
        o, e = compress_pod_gradients({'w': gl[0]}, {'w': el[0]}, axis='pod')
        return o['w'][None], e['w'][None]
    f = shard_map(body, mesh=mesh, in_specs=(P('pod'), P('pod')),
                  out_specs=(P('pod'), P('pod')), check_rep=False)
    o, e = jax.jit(f)(jnp.asarray(g), jnp.asarray(ef))
    out[name] = (np.asarray(o), np.asarray(e))
pickle.dump(out, open(sys.argv[2], 'wb'))
'''

PORT = r'''
import pickle, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.optim.compress import compress_pod_gradients
rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group('gloo', init_method='file://' + d + '/store',
                        rank=rank, world_size=2)
inp = pickle.load(open(d + '/inputs.pkl', 'rb'))
out = {}
for name, (g, ef) in inp.items():
    o, e = compress_pod_gradients({'w': torch.from_numpy(g[rank])},
                                  {'w': torch.from_numpy(ef[rank])},
                                  group=dist.group.WORLD)
    out[name] = (o['w'].numpy(), e['w'].numpy())
# an int8 all_reduce of the 127 + 127 payloads wraps
q = torch.full((4,), 127, dtype=torch.int8)
dist.all_reduce(q)
out['int8_all_reduce'] = q.numpy()
pickle.dump(out, open(d + '/port_%d.pkl' % rank, 'wb'))
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("compress"))
    rng = np.random.default_rng(2)
    inputs = {
        # the reference's cross-pod case, and a ragged one with residuals
        "ramp": (np.stack([np.arange(256, dtype=np.float32) / 64.0,
                           -np.arange(256, dtype=np.float32) / 128.0]),
                 np.zeros((2, 256), np.float32)),
        "ragged": (rng.standard_normal((2, 3, 300)).astype(np.float32),
                   (rng.standard_normal((2, 3, 300)) * 1e-3)
                   .astype(np.float32)),
        # every payload 127 on both ranks: they sum to 254
        "full_scale": (np.full((2, 256), 3.5, np.float32),
                       np.zeros((2, 256), np.float32)),
    }
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE,
                               os.path.join(d, "inputs.pkl"),
                               os.path.join(d, "ref.pkl")],
                              env=ref_env, cwd=ROOT, stderr=subprocess.PIPE,
                              text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT, str(r), d],
                               env=env, cwd=ROOT, stderr=subprocess.PIPE,
                               text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    load = lambda n: pickle.load(open(os.path.join(d, n), "rb"))  # noqa: E731
    return inputs, load("ref.pkl"), [load(f"port_{r}.pkl") for r in range(2)]


def _fused_residual(inputs, name, r):
    """The residual ``target - q * scale`` with the product unrounded (one
    rounding, as XLA's compiled multiply-subtract gives it), from the
    port's quantities on rank ``r``."""
    g, ef = inputs[name]
    targets = [torch.from_numpy(g[i] + ef[i]) for i in range(2)]
    blocks = [C._blockify(t)[0] for t in targets]
    scale = torch.maximum(*(b.abs().amax(-1) / 127.0 for b in blocks))
    safe = torch.where(scale == 0, 1.0, scale)[..., None]
    q = torch.clamp(torch.round(blocks[r] / safe), -127, 127)
    exact = blocks[r].double() - q.double() * safe.double()
    return C._deblockify(exact.float(), targets[r].shape[-1]).numpy(), \
        C._deblockify((q * safe).abs(), targets[r].shape[-1]).numpy()


def test_two_ranks_bitwise_the_reference(two_ranks):
    """Each rank's mean gradient, bitwise the reference's ``shard_map`` run
    over a two-device "pod" axis.  The residual: the reference's jitted
    run contracts ``target - q * scale`` into one rounding (bitwise the
    unrounded-product model here), the port rounds the product first as
    the reference's eager path does (bitwise in the local test), so the
    two residuals part by at most one rounding of the product."""
    inputs, ref, port = two_ranks
    for name in inputs:
        for r in range(2):
            got_out, got_ef = port[r][name]
            assert np.array_equal(_bits(got_out), _bits(ref[name][0][r])), \
                (name, r)
            fused, prod = _fused_residual(inputs, name, r)
            assert np.array_equal(_bits(fused), _bits(ref[name][1][r]))
            assert (np.abs(got_ef - ref[name][1][r])
                    <= np.spacing(prod)).all(), (name, r)
    # the two ranks' gradients differ, their reduced means agree
    assert np.array_equal(port[0]["ramp"][0], port[1]["ramp"][0])
    assert not np.array_equal(inputs["ramp"][0][0], inputs["ramp"][0][1])
    np.testing.assert_allclose(port[0]["ramp"][0], inputs["ramp"][0].mean(0),
                               atol=0.05)


def test_payloads_summing_past_127_do_not_wrap(two_ranks):
    """Both ranks' payloads are 127 (the block's absmax at every entry):
    the sum, 254, comes back as the gradient itself.  Control: an int8
    ``all_reduce`` of the same payloads wraps to -2."""
    inputs, _, port = two_ranks
    for r in range(2):
        np.testing.assert_array_equal(port[r]["full_scale"][0],
                                      inputs["full_scale"][0][r])
        assert np.array_equal(port[r]["int8_all_reduce"],
                              np.full(4, -2, np.int8))
