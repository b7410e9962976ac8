"""QAT training CLI: the original repository's `train.py` surface on the
card (port of `ofq_tpu/cli/train.py`).

  python -m ofq_tpu_torch.cli.train -c configs/deit_imagenet_qat.yml \\
      synthetic --model deit_small_distilled_patch16_224 --wq-enable ...

Runs on CUDA; `main(argv, device="cpu")` runs the plain versions on the
CPU.  Data parallel over N cards of one host:

  torchrun --nproc_per_node N -m ofq_tpu_torch.cli.train ...

(`--batch-size` is the global batch; each rank runs on cuda:LOCAL_RANK).
"""

from __future__ import annotations

import logging
import sys

from ..parallel import initialize_multihost
from .common import parse_args, set_matmul_precision
from .runner import Runner


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
        force=True)


def main(argv=None, device="cuda"):
    setup_logging()
    # joins torchrun's process group (NCCL on the card, gloo on the CPU);
    # a no-op for one process or when the caller has joined one
    initialize_multihost(device=device)
    args = parse_args(argv)
    set_matmul_precision(args.matmul_precision)
    runner = Runner(args, cga_mode=False, device=device)
    best = runner.fit()
    print(f"best top1: {best['top1']:.3f} (epoch {best['epoch']})")
    return best


if __name__ == "__main__":
    main(sys.argv[1:])
