"""Serve a small LM with batched requests through the serving path
(prefill + greedy decode) — the reduced qwen3 config; the same code path
serves the full configs (`launch/serve.py --full`).

Port of the reference's `examples/serve_lm.py`:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \
        [--arch qwen3-0.6b] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..launch import serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve.main(["--arch", args.arch, "--batch", "4",
                       "--prompt-len", "64", "--gen", "24",
                       "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())
