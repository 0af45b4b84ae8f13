"""Serve a small LM with batched requests (the paper's kind: inference).

Counterpart of ``examples/serve_lm.py``: wave-batched serving of
SmolLM-135M, the full-size config by default (on the card), ``--smoke`` for
the tiny one. One prefill and one decode step function serve every request;
like the paper's FPGA, swapping requests touches only state.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cli = ["--arch", "smollm-135m", "--requests", "6", "--max-new", "8",
           "--slots", "3", "--max-len", "48"]
    if args.smoke:
        cli.append("--smoke")
    if args.device is not None:
        cli += ["--device", args.device]
    stats = serve_mod.main(cli)
    assert stats["n_requests"] == 6
    assert stats["new_tokens"] >= 6 * 8
    print("\nserved all requests through one resident prefill and decode path")
    return stats


if __name__ == "__main__":
    main()
