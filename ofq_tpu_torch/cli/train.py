"""QAT training CLI: the original repository's `train.py` surface on the
card (port of `ofq_tpu/cli/train.py`).

  python -m ofq_tpu_torch.cli.train -c configs/deit_imagenet_qat.yml \\
      synthetic --model deit_small_distilled_patch16_224 --wq-enable ...

Runs on CUDA; `main(argv, device="cpu")` runs the plain versions on the
CPU.
"""

from __future__ import annotations

import logging
import sys

from .common import parse_args, set_matmul_precision
from .runner import Runner


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        force=True)


def main(argv=None, device="cuda"):
    setup_logging()
    args = parse_args(argv)
    set_matmul_precision(args.matmul_precision)
    runner = Runner(args, cga_mode=False, device=device)
    best = runner.fit()
    print(f"best top1: {best['top1']:.3f} (epoch {best['epoch']})")
    return best


if __name__ == "__main__":
    main(sys.argv[1:])
