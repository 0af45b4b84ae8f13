"""Train an LM end to end with the production driver.

Counterpart of ``examples/train_lm.py``: the counter-based data pipeline,
the train step (AdamW, clipping, warmup-cosine), async checkpoints every 20
of 60 steps, through :mod:`repro_torch.launch.train`. The reduced SmolLM
config by default; ``--full`` trains smollm-135m at full width (bf16, on
the card). It asserts that the loss decreased.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--full] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="smollm-135m FULL (bf16)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        cli = [
            "--arch", "smollm-135m",
            "--steps", "60",
            "--seq-len", "64",
            "--global-batch", "8",
            "--ckpt-dir", d,
            "--ckpt-every", "20",
            "--log-every", "5",
            "--peak-lr", "1e-3",
        ]
        if not args.full:
            cli.append("--smoke")
        if args.device is not None:
            cli += ["--device", args.device]
        losses = train_mod.main(cli)
        assert losses[-1] < losses[0], "loss must decrease"
        print(f"\nloss decreased {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps (checkpoints + resume exercised)")
    return losses


if __name__ == "__main__":
    main()
