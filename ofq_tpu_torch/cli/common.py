"""CLI argument surface: the original repository's flags and the
two-stage YAML config (port of `ofq_tpu/cli/common.py:21-265`).

The original parses `--config` first, loads the YAML as parser defaults,
then lets CLI flags override (reference: train.py:369-384).  Every flag,
alias, default and choice of the JAX package's parser is kept, so the
shipped train_scripts/ translate 1:1 (`-m ofq_tpu.cli.train` ->
`-m ofq_tpu_torch.cli.train`).  The GPU-process flags (--world_size,
--visible_gpu, --tcp_port) are accepted and ignored; the JAX package's
TPU-named extensions keep their names and say what they do in the port.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import yaml


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ofq_tpu", add_help=True)
    p.add_argument("data_dir", nargs="?", default=None,
                   help="ImageFolder root (train/ + validation/); omit or "
                        "'synthetic' for generated data")
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--dataset", default="imagenet")
    p.add_argument("--num-classes", "--num_classes", dest="num_classes",
                   type=int, default=1000)
    p.add_argument("--img-size", "--img_size", dest="img_size", type=int,
                   default=224)
    p.add_argument("--model", default="deit_tiny_distilled_patch16_224")
    p.add_argument("--model_type", default="deit", choices=["deit", "swin"])
    p.add_argument("--batch-size", "--batch_size", dest="batch_size",
                   type=int, default=128)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--steps-per-epoch", dest="steps_per_epoch", type=int,
                   default=None, help="override (required for synthetic data)")
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--min-lr", "--min_lr", dest="min_lr", type=float,
                   default=1e-5)
    p.add_argument("--warmup-lr", "--warmup_lr", dest="warmup_lr", type=float,
                   default=1e-6)
    p.add_argument("--warmup-epochs", dest="warmup_epochs", type=int, default=5)
    p.add_argument("--cooldown-epochs", dest="cooldown_epochs", type=int,
                   default=10)
    p.add_argument("--sched", default="cosine")
    p.add_argument("--opt", default="adamw")
    p.add_argument("--weight-decay", "--weight_decay", dest="weight_decay",
                   type=float, default=0.05)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--clip-grad", dest="clip_grad", type=float, default=None)
    p.add_argument("--clip-mode", dest="clip_mode", default="norm")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--log-interval", dest="log_interval", type=int, default=50)

    # augmentation
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup-prob", dest="mixup_prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", dest="mixup_switch_prob",
                   type=float, default=0.5)
    p.add_argument("--aa", default="rand-m9-mstd0.5-inc1")
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--remode", default="pixel")
    p.add_argument("--crop-pct", dest="crop_pct", type=float, default=0.9)
    p.add_argument("--drop-path", "--drop_path", dest="drop_path", type=float,
                   default=0.0)
    p.add_argument("--num_aug_repeats", type=int, default=0)

    # quantization
    p.add_argument("--quantized", action="store_true", default=False)
    p.add_argument("--wq-enable", "--wq_enable", dest="wq_enable",
                   action="store_true", default=False)
    p.add_argument("--wq-mode", dest="wq_mode", default="statsq")
    p.add_argument("--wq-bitw", dest="wq_bitw", type=int, default=8)
    p.add_argument("--wq-per-channel", dest="wq_per_channel",
                   action="store_true", default=False)
    p.add_argument("--wq_clip_learnable", dest="wq_clip_learnable",
                   action="store_true", default=False)
    p.add_argument("--aq-enable", "--aq_enable", dest="aq_enable",
                   action="store_true", default=False)
    p.add_argument("--aq-mode", dest="aq_mode", default="lsq")
    p.add_argument("--aq-bitw", dest="aq_bitw", type=int, default=8)
    p.add_argument("--aq-per-channel", dest="aq_per_channel",
                   action="store_true", default=False)
    p.add_argument("--aq_clip_learnable", dest="aq_clip_learnable",
                   action="store_true", default=False)
    p.add_argument("--qmodules", nargs="*", default=None)
    p.add_argument("--act_layer", default="gelu",
                   choices=["relu", "gelu", "prelu", "rprelu", "None"])
    p.add_argument("--apply_q_attn_dropout", type=int, default=0,
                   help="0: quantize attn + dropout, 1: no quant + dropout, "
                        "2: no quant + no dropout, 3: quantize + no dropout "
                        "(reference train.py:357)")
    p.add_argument("--wq_asym", action="store_true", default=False,
                   help="asymmetric (unsigned-range) weight LSQ; requires "
                        "--wq-mode lsq")
    p.add_argument("--qk_reparam", action="store_true", default=False)
    p.add_argument("--qk_reparam_type", type=int, default=0)
    p.add_argument("--boundaryRange", dest="boundary_range", type=float,
                   default=0.005)
    p.add_argument("--freeze_for_n_epochs", type=int, default=30)
    p.add_argument("--cga_no_freeze", action="store_true", default=False,
                   help="CGA-CLI control arm: keep the pinned-LR "
                        "freeze_for_n_epochs finetune window but disable "
                        "the freeze/restore transform entirely — the "
                        "equal-budget baseline that isolates the benefit "
                        "of confidence-guided annealing (reference "
                        "cga.py:450-469) from 'more epochs'. Incompatible "
                        "with --qk_reparam_type 1 (whose quantizer "
                        "freezes in-forward).")
    p.add_argument("--replace-ln-by-bn", dest="replace_ln_by_bn",
                   action="store_true", default=False)

    # pretrained / KD
    p.add_argument("--pretrained", action="store_true", default=False)
    p.add_argument("--pretrained_initialized", action="store_true",
                   default=False)
    p.add_argument("--initial-checkpoint", dest="initial_checkpoint",
                   default="")
    p.add_argument("--use-kd", dest="use_kd", action="store_true",
                   default=False)
    p.add_argument("--teacher", default="deit_tiny_distilled_patch16_224")
    p.add_argument("--teacher_type", default="deit")
    p.add_argument("--teacher_pretrained", action="store_true", default=False)
    p.add_argument("--teacher_checkpoint", default="")
    p.add_argument("--quant_teacher", action="store_true", default=False)
    p.add_argument("--kd_hard_and_soft", type=int, default=0)
    p.add_argument("--use-token-kd", dest="use_token_kd",
                   action="store_true", default=False)
    p.add_argument("--kd-alpha", dest="kd_alpha", type=float, default=0.5)
    p.add_argument("--kd-type", dest="kd_type", default="last")
    p.add_argument("--dampening-loss-weighting", "--dampening_loss_weighting",
                   dest="dampening_loss_weighting", type=float, default=0.0,
                   help="oscillation-dampening regularizer weight "
                        "(reference utils.py:123-144, shipped as 0)")

    # EMA / checkpointing / output
    p.add_argument("--model-ema", dest="model_ema", action="store_true",
                   default=False)
    p.add_argument("--model-ema-decay", dest="model_ema_decay", type=float,
                   default=0.9999)
    p.add_argument("--resume", default="")
    p.add_argument("--no-resume-opt", dest="no_resume_opt",
                   action="store_true", default=False)
    p.add_argument("--output", default="./outputs")
    p.add_argument("--experiment", default="")
    p.add_argument("--eval-metric", dest="eval_metric", default="top1")
    p.add_argument("--checkpoint-hist", dest="checkpoint_hist", type=int,
                   default=10)
    p.add_argument("--recovery-interval", dest="recovery_interval", type=int,
                   default=0)
    p.add_argument("--log-wandb", dest="log_wandb", action="store_true",
                   default=False)
    p.add_argument("--wandb-watch", dest="wandb_watch", action="store_true",
                   default=False,
                   help="per-module gradient-norm telemetry each logged "
                        "step (wandb.watch analog, reference train.py:936)")

    # accepted-and-ignored process-launch flags (reference GPU workflow)
    p.add_argument("--world_size", default=None,
                   help="ignored: torchrun sets the world "
                        "(torchrun --nproc_per_node N -m "
                        "ofq_tpu_torch.cli.train ...)")
    p.add_argument("--visible_gpu", default=None, help="ignored")
    p.add_argument("--tcp_port", default=None, help="ignored")
    p.add_argument("--amp", action="store_true", default=False,
                   help="accepted for compat; use --compute-dtype instead")

    # the JAX package's extensions
    p.add_argument("--mesh-model-parallel", dest="mesh_model_parallel",
                   type=int, default=1,
                   help="the mesh's 'model' axis: tensor parallelism over "
                        "groups of N consecutive ranks (torchrun "
                        "--nproc_per_node ...), the data sharded over the "
                        "rest")
    p.add_argument("--compute-dtype", dest="compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--master-dtype", dest="master_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="param STORAGE dtype; update/quantizer math stays "
                        "fp32 (BASELINE config 5's bf16 master weights)")
    p.add_argument("--matmul-impl", dest="matmul_impl", default="xla",
                   choices=["xla", "pallas", "fused", "int8"],
                   help="QLinear backend: 'xla' the composition, "
                        "'pallas' the StatsQ matmul kernel (K4), 'fused' "
                        "the fused QLinear kernel (K1), 'int8' the integer "
                        "codes through torch._int_mm (W<=4 only, "
                        "ops/int8_qlinear.py)")
    p.add_argument("--attn-impl", dest="attn_impl", default="auto",
                   choices=["auto", "xla", "fused", "remat"],
                   help="attention backend: the composition (default), "
                        "'fused' the softmax/LSQ/attn@v kernels (K2, K3; "
                        "DeiT only), or 'remat' the checkpointed tail")
    p.add_argument("--max-steps", dest="max_steps", type=int, default=None,
                   help="hard stop after N optimizer steps (smoke runs)")
    p.add_argument("--matmul-precision", dest="matmul_precision",
                   default=None, choices=["default", "high", "highest"],
                   help="torch.set_float32_matmul_precision: 'highest' "
                        "and 'high' set it (TF32 allowed under 'high'), "
                        "'default' leaves the setting alone")
    p.add_argument("--track-oscillation", dest="track_oscillation",
                   action="store_true", default=False,
                   help="in-graph integer-domain oscillation telemetry")
    p.add_argument("--profile-steps", dest="profile_steps", type=int,
                   default=0,
                   help="capture a torch.profiler trace of N train "
                        "steps into <experiment>/trace/trace.json (Chrome "
                        "trace format)")
    p.add_argument("--oscillation-freeze-threshold",
                   dest="oscillation_freeze_threshold", type=float,
                   default=0.0)
    return p


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    """Two-stage parse: -c YAML values become defaults, CLI overrides win."""
    cfg_parser = argparse.ArgumentParser(add_help=False)
    cfg_parser.add_argument("-c", "--config", default=None)
    cfg_args, remaining = cfg_parser.parse_known_args(argv)
    parser = build_parser()
    if cfg_args.config:
        with open(cfg_args.config) as f:
            cfg = yaml.safe_load(f) or {}
        known = {a.dest for a in parser._actions}
        renames = {"boundaryRange": "boundary_range"}
        defaults = {}
        for k, v in cfg.items():
            k = renames.get(k, k)
            if k in known:
                defaults[k] = v
        parser.set_defaults(**defaults)
    args = parser.parse_args(remaining)
    args.config = cfg_args.config
    return args


def policy_from_namespace(args) -> "QuantPolicy":
    from ..quant.policy import (
        default_deit_qmodules,
        default_swin_qmodules,
        policy_from_args,
    )

    qmodules = args.qmodules
    if not args.quantized and not args.wq_enable and not args.aq_enable:
        qmodules = ()
    elif qmodules is None:
        if args.model_type == "swin":
            qmodules = default_swin_qmodules()
        else:
            qmodules = default_deit_qmodules(
                12, distilled="distilled" in args.model)
    return policy_from_args(
        wq_enable=args.wq_enable, wq_mode=args.wq_mode, wq_bitw=args.wq_bitw,
        wq_per_channel=args.wq_per_channel,
        wq_learnable=args.wq_clip_learnable,
        wq_asym=getattr(args, "wq_asym", False),
        aq_enable=args.aq_enable, aq_mode=args.aq_mode, aq_bitw=args.aq_bitw,
        aq_per_channel=args.aq_per_channel,
        aq_learnable=args.aq_clip_learnable,
        qmodules=tuple(qmodules or ()),
        qk_reparam=args.qk_reparam, qk_reparam_type=args.qk_reparam_type,
        boundary_range=args.boundary_range, act_layer=args.act_layer,
        apply_q_attn_dropout=getattr(args, "apply_q_attn_dropout", 0),
    )


def experiment_dir(args) -> str:
    name = args.experiment or "default"
    return os.path.join(args.output, name)


def set_matmul_precision(precision) -> None:
    """`--matmul-precision` on torch: 'highest' and 'high' go to
    `torch.set_float32_matmul_precision`; 'default' and None leave the
    setting alone."""
    if precision in ("highest", "high"):
        import torch

        torch.set_float32_matmul_precision(precision)
