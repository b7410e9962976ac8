"""CGA finetune CLI: the original repository's `cga.py` surface on the
card (port of `ofq_tpu/cli/cga.py`).

Loads a phase-1 experiment (--resume / --initial-checkpoint), pins the LR
at the cooldown min_lr (reference cga.py:760-762), and trains
`--freeze_for_n_epochs` epochs with the confidence-guided-annealing
freeze/restore transform in the train step.  Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import sys

from .common import parse_args, set_matmul_precision
from .runner import Runner
from .train import setup_logging


def main(argv=None, device="cuda"):
    setup_logging()
    args = parse_args(argv)
    set_matmul_precision(args.matmul_precision)
    if args.resume and not args.initial_checkpoint:
        args.initial_checkpoint = args.resume
        args.resume = ""
    runner = Runner(args, cga_mode=True, device=device)
    best = runner.fit()
    print(f"best top1: {best['top1']:.3f} (epoch {best['epoch']})")
    return best


if __name__ == "__main__":
    main(sys.argv[1:])
