"""Serve a small model with batched requests (decode path demo), on the
PyTorch/CUDA port.

The counterpart of ``examples/serve_lm.py`` on ``repro_torch``: batched
greedy generation through ``repro_torch.launch.serve.generate`` (the
prompt replayed through the decode step, then greedy tokens) on a smoke
config of the dense family with seeded weights, on ``--device`` (the card
unless ``cpu``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import generate


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for arch in ([args.arch] if args.arch else []):
        toks, tput = generate(arch, batch=args.batch, prompt_len=12,
                              gen_len=12, device=args.device)
        print(f"[serve] {arch}: batch {args.batch}, "
              f"{tput:.1f} tok/s, sample row: {toks[0, :8].tolist()}")


if __name__ == "__main__":
    main()
