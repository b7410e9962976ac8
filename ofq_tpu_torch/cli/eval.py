"""Evaluation CLI: the original repository's `eval.py` surface on the
card (port of `ofq_tpu/cli/eval.py`).

Loads `--resume` (an experiment directory, or an original-layout
`.pth.tar` through the converter) and reports top-1/top-5.  fp32 matmuls
run at full precision unless `--matmul-precision` says otherwise.  Runs
on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import sys

from ..parallel import initialize_multihost
from .common import parse_args, set_matmul_precision
from .runner import Runner
from .train import setup_logging


def main(argv=None, device="cuda"):
    setup_logging()
    initialize_multihost(device=device)  # torchrun's group, as train.main
    args = parse_args(argv)
    set_matmul_precision(args.matmul_precision or "highest")
    runner = Runner(args, cga_mode=False, device=device)
    metrics = runner.evaluate_only()
    print(f"top1: {metrics['top1']:.3f}  top5: {metrics['top5']:.3f}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
