"""Inference serving (port of `ofq_tpu/serve.py`).

    from ofq_tpu_torch.serve import Predictor
    p = Predictor.from_experiment("./outputs/w2a2_deit/cga", batch_size=64)
    probs = p.predict(images_nhwc)          # (B, 1000) softmax

`from_experiment` rebuilds the model from an experiment directory's
args.yaml (the runner's `build_model`) and loads its best (or latest)
checkpoint, the EMA weights when it trained with `--model-ema`;
`export_experiment` freezes it into a packed artifact and
`predictor_from_artifact` serves one (`--int-core`: the integer core).
`python -m ofq_tpu_torch.serve <exp_dir>` is the smoke entry point
(`main`).  Weights carried across from the JAX package serve through
`from_flax_npz`:

    from ofq_tpu_torch.serve import Predictor
    p = Predictor.from_flax_npz("w2a2_deit_s.npz",
                                model_name="deit_small_distilled_patch16_224",
                                policy=w2a2_qkr_policy(12))
    probs = p.predict(images_nhwc)          # (B, 1000) softmax

A frozen packed artifact (`deploy.export_packed`, saved with `np.savez`)
serves through the integer core:

    exported = dict(np.load("w2a2_deit_s_packed.npz"))
    p = Predictor.from_packed(exported,
                              model_name="deit_small_distilled_patch16_224",
                              policy=w2a2_qkr_policy(12), int_core=True,
                              compute_dtype="bfloat16")

A full-LSQ artifact (`--wq-mode lsq`, a policy whose `lsq_weights` holds)
serves the same way, its integer codes rebuilt from the learned weight
scales.  A batch shorter than `batch_size` is padded to it and the result trimmed,
so every call runs the same shapes.  Runs on CUDA unless `device="cpu"`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import yaml

from .convert import load_flax_params
from .deploy import artifact_meta, drop_block_lsq_scales, restore_packed
from .models.registry import create_model, resolve_device
from .ops.int8_qlinear import int8_eligible, lsq_int8_eligible
from .quant.policy import QuantPolicy


def _saved_args(path: str):
    """The CLI namespace of an experiment's args.yaml: the parser's
    defaults overlaid with the saved values."""
    from .cli.common import build_parser

    with open(path) as f:
        saved = yaml.safe_load(f) or {}
    args = build_parser().parse_args([])
    for k, v in saved.items():
        if hasattr(args, k):
            setattr(args, k, v)
    return args


class Predictor:
    def __init__(self, model: torch.nn.Module, *, batch_size: int,
                 img_size: int, device="cuda", epoch: Optional[int] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.img_size = img_size
        # the restored checkpoint's epoch (None when not built from one)
        self.epoch = epoch

    @classmethod
    def from_experiment(cls, exp_dir: str, *, batch_size: int = 64,
                        use_best: bool = True, device="cuda") -> "Predictor":
        """The student of experiment `exp_dir` (a directory of the port's
        runner), rebuilt from its args.yaml, with the best checkpoint's
        (or with `use_best=False` the latest's) weights and buffers; the
        EMA weights when it trained with `--model-ema`."""
        from .cli.common import policy_from_namespace
        from .cli.runner import build_model
        from .train.checkpoint import load, make_manager

        args = _saved_args(os.path.join(exp_dir, "args.yaml"))
        model = build_model(args, policy_from_namespace(args), device=device)
        mgr = make_manager(exp_dir, metric_name=args.eval_metric)
        step = mgr.best_step() if use_best else mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {exp_dir}")
        payload = load(mgr, step)
        params = payload["params"]
        if args.model_ema and payload["ema_params"] is not None:
            params = payload["ema_params"]
        flat = {n.replace(".", "/"): t.float().numpy() if
                t.is_floating_point() else t.numpy()
                for n, t in {**params, **payload["buffers"]}.items()}
        load_flax_params(model, flat)
        return cls(model, batch_size=batch_size, img_size=args.img_size,
                   device=device, epoch=int(payload["epoch"]))

    @classmethod
    def from_flax_npz(cls, npz_path: str, *, model_name: str,
                      policy: QuantPolicy, matmul_impl: str = "fused",
                      attn_impl: str | None = "fused", compute_dtype=None,
                      batch_size: int = 64, device="cuda",
                      **overrides) -> "Predictor":
        """A predictor for JAX variables saved as a flat `.npz` keyed by
        '/'-joined Flax paths (see `convert.load_flax_params`; a BN
        student's running statistics, `batch_stats`, serve in eval mode).
        The bf16 stream of bench.py's pallas configuration:
        `matmul_impl="pallas", attn_impl=None, compute_dtype="bfloat16"`;
        of its fused one: the defaults with `compute_dtype="bfloat16"`.
        `overrides` replace further config fields (e.g.
        `norm_layer="batchnorm"`)."""
        model = create_model(model_name, policy=policy, device=device,
                             matmul_impl=matmul_impl, attn_impl=attn_impl,
                             compute_dtype=compute_dtype, **overrides)
        load_flax_params(model, npz_path)
        return cls(model, batch_size=batch_size,
                   img_size=model.cfg.img_size, device=device)

    @classmethod
    def from_packed(cls, exported, *, model_name: str, policy: QuantPolicy,
                    int_core: bool = True, compute_dtype=None,
                    batch_size: int = 64, device="cuda") -> "Predictor":
        """A predictor for a packed artifact (a dict of arrays, or the path
        of its `.npz`) of the W2A2 student trained under `policy`.  The
        model is built frozen (`weight_frozen=True`, and with `int_core`
        `frozen_int_bits` = the artifact's weight bits: its products run on
        the codes rebuilt from the stored scales), in `bench.py`'s
        configuration (composed attention tail; `compute_dtype` as given)
        and loaded strictly, the image quantizer's state with it (an
        artifact of `deploy.model_tree`; the JAX package's exports hold the
        params collection alone: restore those with `restore_packed` and
        load them with their `quant_stats`)."""
        if isinstance(exported, (str, bytes)) or hasattr(exported,
                                                         "__fspath__"):
            with np.load(exported) as npz:
                exported = dict(npz)
        meta = artifact_meta(exported)
        bits = meta["weight_bits"]
        lsq = policy.lsq_weights
        asym = not policy.weight.symmetric
        if bool(meta["qk_reparam"]) != policy.qk_reparam or \
                meta["wq_mode"] != ("lsq" if lsq else "statsq") or \
                bool(meta.get("wq_asym", False)) != asym or \
                bits != policy.weight.bit:
            raise ValueError(
                f"artifact (W{bits}, qk_reparam={meta['qk_reparam']}, "
                f"wq_mode={meta['wq_mode']!r}, wq_asym="
                f"{meta.get('wq_asym', False)}) does not match the policy "
                f"(W{policy.weight.bit}, qk_reparam={policy.qk_reparam}, "
                f"full-LSQ {lsq}, wq_asym={asym})")
        if int_core and lsq and (policy.qk_reparam or not lsq_int8_eligible(
                bits, policy.act.bit, True, asym)):
            raise ValueError(f"int_core serves full-LSQ artifacts without "
                             f"QKR at W2..W{7 if asym else 8} / A<=7, got "
                             f"W{bits}A{policy.act.bit}, qk_reparam="
                             f"{policy.qk_reparam}")
        if int_core and not lsq and not int8_eligible(bits, policy.act.bit,
                                                      True):
            # outside these widths the layers would serve the fp frozen
            # path under an int-core name
            raise ValueError(f"int_core serves W2..W4 / A<=7 artifacts, got "
                             f"W{bits}A{policy.act.bit}")
        frozen = dataclasses.replace(
            policy, weight_frozen=True,
            frozen_int_bits=bits if int_core else None)
        model = create_model(model_name, policy=frozen, device=device,
                             compute_dtype=compute_dtype)
        tree = restore_packed(exported, int_core=int_core)
        if lsq and not int_core:
            tree = drop_block_lsq_scales(tree)
        load_flax_params(model, tree)
        return cls(model, batch_size=batch_size,
                   img_size=model.cfg.img_size, device=device)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: (B, H, W, 3) float32 NHWC, already normalized, with
        B <= batch_size.  Returns (B, classes) softmax probabilities."""
        n = images.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch of {n} > batch_size {self.batch_size}")
        pad = self.batch_size - n
        x = np.pad(np.asarray(images, np.float32),
                   ((0, pad), (0, 0), (0, 0), (0, 0)))
        with torch.inference_mode():
            xt = torch.from_numpy(x).to(self.device)
            probs = torch.softmax(self.model(xt), dim=-1)
            return probs[:n].cpu().numpy()


def export_experiment(exp_dir: str, out_path: str, *, use_best: bool = True,
                      device="cuda") -> str:
    """Freeze a trained experiment into a packed-integer artifact
    (`deploy.export_packed` of `deploy.model_tree`, the image quantizer's
    state and a BN model's running statistics with it), one `.npz`."""
    from .deploy import artifact_nbytes, export_packed, model_tree

    args = _saved_args(os.path.join(exp_dir, "args.yaml"))
    if not (args.wq_enable and args.aq_enable):
        raise NotImplementedError(
            "packed export needs BOTH weight and activation quantizers "
            "enabled (wq_enable/aq_enable); with either off the kernels "
            "are not StatsQ-faithful at wq_bitw bits and packing would "
            "corrupt them. Every shipped recipe enables both.")
    p = Predictor.from_experiment(exp_dir, batch_size=1, use_best=use_best,
                                  device=device)
    cfg = p.model.cfg
    if args.model_type == "swin":
        hk = {"head_dim": cfg.embed_dim // cfg.num_heads[0]}
    else:
        hk = {"num_heads": cfg.num_heads}
    exported = export_packed(
        model_tree(p.model), weight_bits=args.wq_bitw,
        qk_reparam=args.qk_reparam, wq_mode=args.wq_mode,
        wq_asym=getattr(args, "wq_asym", False), **hk)
    np.savez(out_path, **exported)
    fp32 = sum(t.numel() * 4 for t in p.model.parameters())
    print(f"exported {out_path}: {artifact_nbytes(exported) / 1e6:.1f} MB "
          f"(fp32 checkpoint: {fp32 / 1e6:.1f} MB)")
    return out_path


def predictor_from_artifact(npz_path: str, args_yaml: str, *,
                            batch_size: int = 64, int_core: bool = False,
                            device="cuda") -> Predictor:
    """A frozen-weight Predictor from a packed artifact and the
    experiment's args.yaml (the model and policy; every model flag of the
    experiment applies, through the runner's `build_model`).  The
    artifact's own weight bits, QKR, weight mode and asymmetry must match
    the args.yaml.  `int_core=True` serves through the integer core (the
    artifact's codes, `torch._int_mm` on the card) for StatsQ recipes at
    W2..W4 / A<=7 and full-LSQ recipes without QKR."""
    from .cli.common import policy_from_namespace
    from .cli.runner import build_model

    args = _saved_args(args_yaml)
    with np.load(npz_path) as npz:
        exported = dict(npz)
    meta = artifact_meta(exported)
    if meta["weight_bits"] != args.wq_bitw:
        raise ValueError(
            f"artifact {npz_path} was packed at W{meta['weight_bits']} but "
            f"{args_yaml} says wq_bitw={args.wq_bitw}; wrong exp_dir for "
            f"this artifact")
    if bool(meta.get("qk_reparam", False)) != bool(args.qk_reparam):
        raise ValueError(
            f"artifact qk_reparam={meta.get('qk_reparam')} != args.yaml "
            f"qk_reparam={args.qk_reparam}; wrong exp_dir for this artifact")
    if meta.get("wq_mode", "statsq") != args.wq_mode:
        raise ValueError(
            f"artifact wq_mode={meta.get('wq_mode', 'statsq')!r} != "
            f"args.yaml wq_mode={args.wq_mode!r}; wrong exp_dir for this "
            f"artifact")
    asym = bool(getattr(args, "wq_asym", False))
    if bool(meta.get("wq_asym", False)) != asym:
        raise ValueError(
            f"artifact wq_asym={bool(meta.get('wq_asym', False))} != "
            f"args.yaml wq_asym={asym}; wrong exp_dir for this artifact")
    lsq = args.wq_mode == "lsq"
    if int_core and lsq:
        if args.qk_reparam:
            raise ValueError(
                "--int-core with --wq-mode lsq does not support "
                "--qk_reparam artifacts; serve without --int-core")
        if not lsq_int8_eligible(args.wq_bitw, args.aq_bitw, True, asym):
            raise ValueError(
                f"--int-core full-LSQ supports W2..W{7 if asym else 8} / "
                f"A<=7 artifacts, got W{args.wq_bitw}A{args.aq_bitw}; serve "
                f"without --int-core")
    elif int_core and not int8_eligible(args.wq_bitw, args.aq_bitw, True):
        raise ValueError(
            f"--int-core supports W2..W4 / A<=7 artifacts, got "
            f"W{args.wq_bitw}A{args.aq_bitw}; serve without --int-core")
    policy = dataclasses.replace(
        policy_from_namespace(args), weight_frozen=True,
        frozen_int_bits=args.wq_bitw if int_core else None)
    model = build_model(args, policy, device=device)
    tree = restore_packed(exported, int_core=int_core)
    if lsq and not int_core:
        tree = drop_block_lsq_scales(tree)
    load_flax_params(model, tree)
    return Predictor(model, batch_size=batch_size, img_size=args.img_size,
                     device=device)


def main(argv=None, device="cuda"):
    """Serve an experiment once on seeded images (`--bench-iters N`: time
    N calls and print the rate), freeze it (`--export`), or serve a
    packed artifact (`--artifact`, `--int-core`)."""
    ap = argparse.ArgumentParser("ofq-serve smoke")
    ap.add_argument("exp_dir")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--export", default=None, metavar="OUT_NPZ",
                    help="freeze the experiment into a packed-integer "
                         "deployment artifact instead of serving")
    ap.add_argument("--artifact", default=None, metavar="NPZ",
                    help="serve a packed artifact (exp_dir supplies "
                         "args.yaml) instead of restoring a checkpoint")
    ap.add_argument("--int-core", action="store_true",
                    help="serve the artifact through the integer core "
                         "(torch._int_mm, exact integer accumulation)")
    ap.add_argument("--bench-iters", type=int, default=0,
                    help="time N predict() calls and report img/s")
    a = ap.parse_args(argv)
    if a.export:
        export_experiment(a.exp_dir, a.export, device=device)
        return None
    if a.artifact:
        p = predictor_from_artifact(
            a.artifact, os.path.join(a.exp_dir, "args.yaml"),
            batch_size=a.batch_size, int_core=a.int_core, device=device)
    else:
        if a.int_core:
            ap.error("--int-core requires --artifact (the integer core "
                     "consumes packed codes)")
        p = Predictor.from_experiment(a.exp_dir, batch_size=a.batch_size,
                                      device=device)
    x = np.random.default_rng(0).normal(
        size=(a.batch_size, p.img_size, p.img_size, 3)).astype(np.float32)
    probs = p.predict(x)
    print("predict ok:", probs.shape, "max prob:", float(probs.max()))
    if a.bench_iters:
        t0 = time.perf_counter()
        for _ in range(a.bench_iters):
            probs = p.predict(x)
        dt = time.perf_counter() - t0
        print(f"serving rate: {a.batch_size * a.bench_iters / dt:.1f} "
              f"img/s (B={a.batch_size}, int_core={a.int_core})")
    return p


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
