"""Architecture registry: the 10 assigned architectures (a copy of
``repro.configs``, pointing at the port's ``ModelConfig``).

Each module defines ``CONFIG`` (published numbers) and ``SMOKE`` (reduced,
same family — used by the per-arch CPU smoke tests).  ``get_config`` is the
single lookup used by the serving driver and the tests.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "mamba2_130m",
    "dbrx_132b",
    "deepseek_v2_lite_16b",
    "qwen3_14b",
    "gemma3_1b",
    "nemotron_4_340b",
    "command_r_35b",
    "llava_next_34b",
    "seamless_m4t_large_v2",
    "jamba_1_5_large_398b",
]

# canonical dashed ids (CLI) -> module names
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    key = name.replace("-", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    return key


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE if smoke else mod.CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shapes_for(cfg) -> dict:
    """Applicable shapes for an arch (long_500k only when sub-quadratic —
    DESIGN.md §4); skipped cells are still reported by the dry-run."""
    out = {}
    for name, spec in SHAPES.items():
        if name == "long_500k" and not cfg.sub_quadratic():
            continue
        out[name] = spec
    return out
