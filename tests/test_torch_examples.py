"""Every ``examples/torch_*.py`` runs on the CPU (``--device cpu``) and
prints its key lines, each in a subprocess where ``jax`` and ``repro``
cannot be imported: the port's examples need neither."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# example -> (arguments beside --device cpu, lines its output must hold);
# a size flag where the reference's size takes more than ~10 s here
EXAMPLES = {
    "torch_quickstart.py": ([], ["FP64 V3   : max|L - chol(A)|",
                                 "solve(b)  : max|Ax - b|",
                                 "MxP  V3   : rel residual",
                                 "modeled speedup MxP vs FP64"]),
    "torch_ooc_policy_comparison.py": (
        ["--n", "2048"], ["--- gh200 (modeled) ---", "Fig.7-style trace",
                          "--- multi-device V3", "--- executed on cpu"]),
    "torch_geospatial_mle.py": ([], ["=== correlation weak",
                                     "FP64 log-likelihood:", "KL=",
                                     "FP64 solver reuse across 3 regimes"]),
    "torch_autotune.py": ([], ["auto-resolved for gh200:",
                               "top candidates on a100-pcie",
                               "measured model: measured-cpu",
                               "tuned for THIS machine:"]),
    "torch_serve_lm.py": ([], ["[serve] gemma3-1b: batch 8"]),
    "torch_train_lm.py": (["--steps", "3", "--batch", "2", "--seq", "32"],
                          ["[example] loss"]),
}

_BLOCKED = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name='__main__')
"""


def test_every_port_example_is_listed():
    found = sorted(f for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.startswith("torch_") and f.endswith(".py"))
    assert found == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, lines = EXAMPLES[name]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TUNE_DB=str(tmp_path / "tune_db.json"))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED,
         os.path.join(ROOT, "examples", name), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for line in lines:
        assert line in proc.stdout, (line, proc.stdout[-2000:])
