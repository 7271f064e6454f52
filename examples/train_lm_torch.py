"""End-to-end LM training on the PyTorch/CUDA port: data pipeline ->
train step over the host mesh -> atomic checkpoints -> restart-resume —
the counterpart of ``examples/train_lm.py``.

A reduced qwen3-family model (~90k params) on the synthetic Zipf/ngram
stream, through ``repro_torch.launch.train.main``: its state laid out as
DTensors on the host mesh (this process alone, or the ranks ``torchrun``
started).  The same launcher trains the full configs on the cards by
dropping ``--smoke``.  Restart the same command after a kill: it resumes
from the newest checkpoint.

    PYTHONPATH=src python examples/train_lm_torch.py              # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 50
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    argv = ["--arch", "qwen3-1.7b", "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "64", "--lr", "3e-3",
            "--microbatches", "2",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
            "--log-every", "20"]
    if args.device:
        argv += ["--device", args.device]
    return T.main(argv)


if __name__ == "__main__":
    main()
