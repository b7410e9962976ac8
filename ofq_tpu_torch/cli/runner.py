"""The train/eval runner behind the CLIs (port of
`ofq_tpu/cli/runner.py:40-872`).

The original's harness (reference: train.py:444-858 `main`,
train_one_epoch :860, validate :1012, eval.py, cga.py) around the port's
train step: data iteration, epoch bookkeeping, checkpoints, the CSV
summary and logging on the host; every step on the device.  Runs on CUDA
unless the caller passes `device="cpu"`; a missing card raises.

Where the port differs from the JAX runner:

  * Random streams.  JAX splits `key` into (key, sk, mk) at every step.
    The port gives `train_step` one `torch.Generator` on the device,
    seeded from `--seed`, for dropout and drop-path, and draws mixup's
    six values from a second one, seeded from `--seed + 1`.  A port run
    and a JAX run therefore agree only when both start from the same
    weights and nothing is drawn at random after that (no dropout,
    drop-path or mixup).  Weights drawn at initialisation differ too
    (`create_model`'s generator against `jax.random.key`): warm-start
    both from one file to compare them.
  * Checkpoints are synchronous `torch.save` files
    (`train/checkpoint.py`), not orbax directories: a JAX experiment does
    not restore here; its weights load through `convert.load_flax_params`
    (a pickle of the Flax params tree through `--initial-checkpoint`).
  * The SIGTERM handler is installed when `fit` starts and the previous
    one restored on every way out of `fit`.
  * One process.  JAX's multi-process branches (`host_batch_slice`,
    `local_to_global`, `make_mesh`/`shard_params`) are not ported yet:
    `--mesh-model-parallel` above 1, or a `WORLD_SIZE` above 1, raises
    `NotImplementedError` (ROADMAP.md, Queue 1 item 7).

The variables move between the steps of the set-up as Flax trees of
numpy arrays ({collection: nested dict}, `convert.model_variables`), so
the JAX package's tree functions (`merge_pretrained`,
`split_qkv_for_qkr`, the scale pruning) apply as they are; each step
leaves the model loaded with the tree it returns.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import logging
import os
import signal
import time
from typing import Optional

import numpy as np
import torch
import yaml

from ..calibrate import calibrate
from ..convert import (buffer_collection, convert_bn_stats, convert_deit,
                       convert_swin, load_flax_params, load_torch_state_dict,
                       merge_pretrained, model_variables, nest,
                       split_qkv_for_qkr)
from ..data import DataConfig, make_dataset, mixup_cutmix
from ..data.pipeline import num_samples
from ..models import create_model
from ..models import deit as deit_models
from ..models import swin as swin_models
from ..models.registry import resolve_device
from ..quant.policy import QuantPolicy
from ..train import TrainState, make_eval_step, make_optimizer, make_train_step
from ..train.checkpoint import (load, make_manager, restore_best,
                                restore_into, restore_latest, save_epoch)
from ..train.schedule import constant_lr, cosine_with_warmup_cooldown
from .common import experiment_dir, policy_from_namespace

_logger = logging.getLogger("ofq_tpu_torch")

_TORCH_SUFFIXES = (".pth", ".pth.tar", ".pt", ".bin")


def select_loss_kind(args) -> str:
    """Reference loss selection (train.py:744-766)."""
    if getattr(args, "use_token_kd", False):
        return "kd_token"
    if args.use_kd:
        return {0: "kd_soft", 1: "kd_soft_hard", 2: "kd_qk",
                3: "kd_qkv"}[args.kd_hard_and_soft]
    return "ce"


def model_overrides(args, policy, *, teacher: bool = False):
    """(name, policy, config overrides) of the student or the teacher, as
    the JAX runner's `build_model` chooses them."""
    name = args.teacher if teacher else args.model
    mtype = args.teacher_type if teacher else args.model_type
    qqkkvv = args.use_kd and args.kd_hard_and_soft in (2, 3)
    over = dict(num_classes=args.num_classes, qqkkvv=qqkkvv)
    if getattr(args, "use_token_kd", False) and mtype == "deit":
        over["return_features"] = True
    if mtype == "swin":
        over["drop_path_rate"] = args.drop_path
    elif args.drop_path:
        over["drop_path_rate"] = args.drop_path
    if args.img_size != 224:
        over["img_size"] = args.img_size
    if args.replace_ln_by_bn and not teacher:
        # reference --replace-ln-by-bn (train.py:521-522): student only
        over["norm_layer"] = "batchnorm"
    if not teacher:
        if args.matmul_impl and args.matmul_impl != "xla":
            over["matmul_impl"] = args.matmul_impl
        attn_impl = getattr(args, "attn_impl", "auto")
        if attn_impl == "auto":
            attn_impl = None
        if attn_impl and attn_impl != "xla":
            if mtype == "deit" or attn_impl == "remat":
                # 'fused' (K2, K3) stays DeiT-only, as in JAX: Swin's
                # 49-token windows go through the composition
                over["attn_impl"] = attn_impl
            else:
                _logger.warning(
                    "--attn-impl %s is DeiT-only (Swin's windowed cells are "
                    "too small for the fused core); using the composition",
                    attn_impl)
    if args.compute_dtype and args.compute_dtype != "float32":
        over["compute_dtype"] = args.compute_dtype
    if teacher:
        if args.quant_teacher:
            # reference --quant_teacher (train.py:436-441): W4A4 teacher
            pol = dataclasses.replace(
                policy, weight=dataclasses.replace(policy.weight, bit=4),
                act=dataclasses.replace(policy.act, bit=4))
        else:
            pol = QuantPolicy()
    else:
        pol = policy
    return name, pol, over


def build_model(args, policy, *, teacher: bool = False, device="cuda",
                generator: Optional[torch.Generator] = None):
    """The student (or the teacher) of `args` on `device`, its weights
    drawn from `generator` (seed 0 when None)."""
    name, pol, over = model_overrides(args, policy, teacher=teacher)
    return create_model(name, policy=pol, device=device,
                        generator=generator, **over)


def _model_shapes(args, policy) -> dict:
    """{name: shape} of the student of `args`, built on the meta device
    (no memory, no initialisation)."""
    name, pol, over = model_overrides(args, policy)
    make = (deit_models.deit_model if name in deit_models.VARIANTS
            else swin_models.swin_model)
    with torch.device("meta"):
        m = make(name, pol, **over)
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


def _prune_unloaded_scales(dest, loaded):
    """Drop every LSQ scale leaf ('s') of `dest` that `loaded` did not
    provide (path absent or shape mismatch: the criterion
    merge_pretrained copies by).  Returns (pruned_tree, n_pruned)."""
    pruned = {}
    n = 0
    for k, v in dest.items():
        lv = loaded.get(k) if isinstance(loaded, dict) else None
        if isinstance(v, dict):
            sub, m = _prune_unloaded_scales(
                v, lv if isinstance(lv, dict) else {})
            if sub:
                pruned[k] = sub
            n += m
        elif k == "s" and (
                lv is None or tuple(np.shape(lv)) != tuple(np.shape(v))):
            n += 1
        else:
            pruned[k] = v
    return pruned, n


def _leaf_names(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_names(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,))


def recalibrate_missing_scales(model, variables, loaded, image):
    """Re-initialise every LSQ scale `loaded` did not provide, from one
    eval-mode forward with the loaded weights in place (the original's
    load-then-setup_alpha order): each such quantizer, in call order,
    sets its scale from the input it sees, every later one seeing the
    earlier ones' new scales (JAX's lazy Flax init of the pruned
    scales); the other quantizers keep their scales and quantize with
    them.  The forward takes the composed path, as `calibrate` does.
    Leaves `model` loaded; returns (new_variables, n_redone)."""
    pruned, n = _prune_unloaded_scales(variables["params"], loaded)
    if n == 0:
        load_flax_params(model, variables)
        return variables, 0
    missing = set(_leaf_names(variables["params"])) - set(_leaf_names(pruned))
    load_flax_params(model, variables)
    flagged = []
    for name, m in model.named_modules():
        if not hasattr(m, "calibrating"):
            continue
        if isinstance(getattr(m, "s", None), torch.nn.Parameter):
            if (f"{name}.s" if name else "s") not in missing:
                continue
        flagged.append(m)
    p = next(model.parameters())
    x = torch.as_tensor(np.asarray(image)).to(device=p.device, dtype=p.dtype)
    was_training = model.training
    model.eval()
    try:
        for m in flagged:
            m.calibrating = True
        with torch.no_grad():
            model(x)
    finally:
        for m in flagged:
            m.calibrating = False
        model.train(was_training)
    return {**variables, "params": model_variables(model)["params"]}, n


def _check_one_process(args) -> None:
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if getattr(args, "mesh_model_parallel", 1) > 1 or world > 1:
        raise NotImplementedError(
            f"--mesh-model-parallel {args.mesh_model_parallel}, WORLD_SIZE "
            f"{world}: the port runs one process on one device; the "
            "parallel/ layer is not ported yet (ROADMAP.md, Queue 1 item 7)")


class Runner:
    def __init__(self, args, *, cga_mode: bool = False, device="cuda"):
        _check_one_process(args)
        self.args = args
        self.cga_mode = cga_mode
        self.device = resolve_device(device)
        self.policy = policy_from_namespace(args)
        self.model = build_model(
            args, self.policy, device=self.device,
            generator=torch.Generator().manual_seed(args.seed))
        self.loss_kind = select_loss_kind(args)
        self.teacher = (build_model(args, self.policy, teacher=True,
                                    device=self.device,
                                    generator=torch.Generator().manual_seed(0))
                        if self.loss_kind != "ce" else None)
        self.out_dir = experiment_dir(args)
        data_dir = args.data_dir
        if data_dir in ("synthetic", "", None):
            data_dir = None
        self.data_cfg = DataConfig(
            data_dir=data_dir, img_size=args.img_size,
            batch_size=args.batch_size, num_classes=args.num_classes,
            crop_pct=args.crop_pct, aa=args.aa or None, reprob=args.reprob,
            seed=args.seed, num_aug_repeats=args.num_aug_repeats,
            synthetic_length=args.batch_size * (args.steps_per_epoch or 4))
        self._prof = None

    # ------------------------------------------------------------ setup
    def calibrate_init(self, batch) -> dict:
        """Every LSQ scale of the student (its weights drawn from `--seed`
        when the Runner was built) from one eval-mode forward on `batch`
        (the original's setup_alpha, train.py:997-1010).  Returns the
        variables; the model holds them."""
        self.model.eval()
        calibrate(self.model, batch["image"])
        return model_variables(self.model)

    def recalibrate_scales(self, variables, loaded, batch) -> dict:
        """Re-initialise every LSQ scale the checkpoint did not provide,
        from activations computed with the loaded weights
        (`recalibrate_missing_scales`); scales the checkpoint carries are
        kept.  The model holds the result."""
        out, n = recalibrate_missing_scales(self.model, variables, loaded,
                                            batch["image"])
        if n:
            _logger.info(
                "recalibrated %d LSQ scales from the loaded weights "
                "(setup_alpha ordering, reference train.py:515-516 -> :997)",
                n)
        return out

    def restore_experiment_params(self, exp_dir: str, variables,
                                  *, use_ema: bool | None = False,
                                  return_loaded: bool = False):
        """The best checkpoint's variables of experiment `exp_dir`,
        overlaid onto `variables` by path and shape (the original's
        strict=False resume: a CGA phase starts from a fused-qkv phase 1).

        The saved model is rebuilt from the experiment's args.yaml (on the
        meta device) and the checkpoint must hold exactly its
        parameters.  use_ema: False loads the raw weights (warm starts);
        None = auto: the EMA weights when the experiment trained with
        --model-ema (the weights that scored its retention).  A fused qkv
        is split only when the destination is QKR-shaped.  The
        checkpoint's buffers overlay the collections `variables` has
        (BN running statistics, the image quantizer's `signed`)."""
        saved_args = self.args
        args_path = os.path.join(exp_dir, "args.yaml")
        if os.path.exists(args_path):
            with open(args_path) as f:
                saved = yaml.safe_load(f) or {}
            saved_args = argparse.Namespace(**{**vars(self.args), **saved})
        shapes = _model_shapes(saved_args, policy_from_namespace(saved_args))
        mgr = make_manager(exp_dir, metric_name=self.args.eval_metric)
        payload = restore_best(mgr)
        if payload is None:
            raise FileNotFoundError(f"no checkpoints under {exp_dir}")
        got = {n: tuple(t.shape) for n, t in payload["params"].items()}
        if got != shapes:
            bad = sorted(set(got) ^ set(shapes))[:5] or sorted(
                n for n in got if got[n] != shapes[n])[:5]
            raise ValueError(f"{exp_dir}: the checkpoint does not match the "
                             f"model of its args.yaml: {bad}")
        src = payload["params"]
        if use_ema is None:
            use_ema = bool(getattr(saved_args, "model_ema", False))
        if use_ema and payload["ema_params"] is not None:
            _logger.info("restoring EMA weights (the retention metric's)")
            src = payload["ema_params"]
        loaded = nest(src)
        dest = variables["params"]
        common = [k for k in dest if k in loaded and isinstance(dest[k], dict)]
        needs_split = any(
            isinstance(dest[b].get("attn"), dict)
            and "q_kernel" in dest[b]["attn"]
            and "qkv" in (loaded[b].get("attn") or {})
            for b in common)
        if needs_split:
            loaded = split_qkv_for_qkr(loaded)
        out = {**variables, "params": merge_pretrained(dest, loaded)}
        colls: dict = {}
        for n, t in payload["buffers"].items():
            colls.setdefault(buffer_collection(n), {})[n] = t
        for coll, named in colls.items():
            if coll in variables:
                out[coll] = merge_pretrained(variables[coll], nest(named))
        return (out, loaded) if return_loaded else out

    def load_pretrained(self, variables, calib_batch=None) -> dict:
        """Overlay `--initial-checkpoint` (an experiment directory, an
        original-layout `.pth`/`.pth.tar`/`.pt`/`.bin`, or a pickle of
        the Flax params tree); with `calib_batch`, re-calibrate every LSQ
        scale the checkpoint did not provide.  The model holds the
        result."""
        args = self.args
        path = args.initial_checkpoint
        if not path:
            if args.pretrained_initialized:
                raise ValueError(
                    "--pretrained_initialized requires --initial-checkpoint "
                    "<local FP checkpoint> (nothing is downloaded; pass the "
                    "file explicitly). Training from random init will not "
                    "reach the recipe's accuracy.")
            return variables
        _logger.info("loading initial checkpoint %s", path)
        if os.path.isdir(path):
            out, loaded = self.restore_experiment_params(
                path, variables, return_loaded=True)
        else:
            if path.endswith(_TORCH_SUFFIXES):
                sd = load_torch_state_dict(path)
                if args.model_type == "swin":
                    loaded = convert_swin(sd, img_size=args.img_size)
                else:
                    loaded = convert_deit(sd, depth=self.model.cfg.depth,
                                          img_size=args.img_size)
                if self.policy.qk_reparam:
                    loaded = split_qkv_for_qkr(loaded)
            else:  # a pickle of the Flax params tree
                import pickle

                with open(path, "rb") as f:
                    loaded = pickle.load(f)
            out = {**variables,
                   "params": merge_pretrained(variables["params"], loaded)}
            if path.endswith(_TORCH_SUFFIXES) and "batch_stats" in variables:
                bn = convert_bn_stats(sd)
                if bn:
                    out["batch_stats"] = merge_pretrained(
                        variables["batch_stats"], bn)
        if calib_batch is not None:
            return self.recalibrate_scales(out, loaded, calib_batch)
        load_flax_params(self.model, out)
        return out

    def build_optimizer(self, steps_per_epoch: int):
        """(AdamW, lr by epoch): the cosine schedule with warmup, or CGA's
        rate pinned at `--min-lr` (cga.py:760); the step's rate is the
        rate of epoch count // steps_per_epoch."""
        args = self.args
        if self.cga_mode:
            lr_epoch = constant_lr(args.min_lr)
        else:
            lr_epoch = cosine_with_warmup_cooldown(
                args.lr, epochs=args.epochs,
                warmup_epochs=args.warmup_epochs,
                warmup_lr=args.warmup_lr, min_lr=args.min_lr)
        lr_fn = lambda count: lr_epoch(count // steps_per_epoch)  # noqa: E731
        return make_optimizer(
            lr_fn, weight_decay=args.weight_decay,
            clip_grad=args.clip_grad, clip_mode=args.clip_mode), lr_epoch

    # ------------------------------------------------------------- fit
    def _stop_profiler(self):
        """Close an open --profile-steps trace; safe to call repeatedly."""
        if self._prof is not None:
            path = self._prof.stop()
            self._prof = None
            _logger.info("profiler trace written to %s", path)

    def _save_recovery(self, total_steps: int, state) -> bool:
        """Write a step-indexed recovery snapshot, never deleting before
        saving (max_to_keep=2 keeps the previous one until the new one is
        complete).  A snapshot of the same step from a prior run's
        lineage is replaced with the live state; one this run already
        wrote is kept."""
        if not hasattr(self, "_recovery_mgr"):
            self._recovery_mgr = make_manager(
                os.path.join(self.out_dir, "recovery"), max_to_keep=2)
            self._recovery_saved = set()
        if total_steps in self._recovery_saved:
            return False
        if total_steps in self._recovery_mgr.all_steps():
            _logger.warning(
                "recovery snapshot for step %d exists from a prior run; "
                "replacing it with the live state", total_steps)
            self._recovery_mgr.delete(total_steps)
        save_epoch(self._recovery_mgr, total_steps, state,
                   buffers=dict(self.model.named_buffers()))
        self._recovery_saved.add(total_steps)
        return True

    def fit(self) -> dict:
        """Train (or, in CGA mode, finetune) to the end of the schedule;
        returns {"top1", "epoch"} of the best epoch.  SIGTERM finishes the
        step in flight, saves a recovery snapshot and returns; the
        previous SIGTERM handler is restored however `fit` ends."""
        self._preempted = False

        def _on_sigterm(signum, frame):
            self._preempted = True
            _logger.warning("SIGTERM received: will checkpoint and exit at "
                            "the next step boundary")

        try:
            previous = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread
            previous = None
        try:
            return self._fit()
        finally:
            self._stop_profiler()
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _wandb(self):
        try:
            import wandb
        except ImportError:
            _logger.warning("--log-wandb set but wandb missing")
            return None
        if wandb.run is None:
            wandb.init(project="ofq_tpu", name=self.args.experiment or None,
                       config=vars(self.args))
        return wandb

    def _setup_teacher(self) -> None:
        args = self.args
        if args.teacher_pretrained and not args.teacher_checkpoint:
            raise ValueError(
                "--teacher_pretrained requires --teacher_checkpoint <local "
                "FP checkpoint>; distilling from a randomly initialized "
                "teacher would silently destroy accuracy.")
        tvars = model_variables(self.teacher)
        tparams = tvars["params"]
        if args.teacher_checkpoint and os.path.isdir(args.teacher_checkpoint):
            tparams = self.restore_experiment_params(
                args.teacher_checkpoint, {"params": tparams})["params"]
        elif args.teacher_checkpoint:
            sd = load_torch_state_dict(args.teacher_checkpoint)
            conv = convert_swin if args.teacher_type == "swin" else \
                convert_deit
            tparams = merge_pretrained(tparams, conv(sd))
        load_flax_params(self.teacher, {**tvars, "params": tparams})
        if getattr(args, "compute_dtype", "float32") == "bfloat16":
            # the frozen teacher's weights stored in bf16, as in JAX
            self.teacher.to(torch.bfloat16)

    def _device_batch(self, batch) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    def _fit(self) -> dict:
        args = self.args
        os.makedirs(self.out_dir, exist_ok=True)
        wandb = self._wandb() if args.log_wandb else None
        with open(os.path.join(self.out_dir, "args.yaml"), "w") as f:
            yaml.safe_dump(vars(args), f)

        train_it = make_dataset(self.data_cfg, train=True)
        steps_per_epoch = args.steps_per_epoch or max(
            num_samples(self.data_cfg, train=True) // args.batch_size, 1)
        calib_cfg = dataclasses.replace(self.data_cfg, seed=args.seed,
                                        eval_transform=True)
        first = next(iter(make_dataset(calib_cfg, train=True)))
        variables = self.calibrate_init(first)
        self.load_pretrained(variables, calib_batch=first)
        tx, lr_epoch = self.build_optimizer(steps_per_epoch)
        if self.teacher is not None:
            self._setup_teacher()

        master_dtype = getattr(args, "master_dtype", "float32")
        state = TrainState.create(self.model, tx, ema=args.model_ema,
                                  master_dtype=master_dtype)
        osc_cfg = None
        if getattr(args, "track_oscillation", False):
            from ..train.oscillation_hook import init_oscillation_states

            state.extra = {"oscillation": init_oscillation_states(
                state.params, bits=args.wq_bitw, qk_reparam=args.qk_reparam,
                model_type=args.model_type)}
            osc_cfg = dict(
                bits=args.wq_bitw,
                freeze_threshold=args.oscillation_freeze_threshold,
                qk_reparam=args.qk_reparam, model_type=args.model_type)
        cga_cfg = None
        if self.cga_mode and getattr(args, "cga_no_freeze", False):
            # the equal-budget control: pinned LR, no freezing; type 1's
            # quantizer would still freeze in-forward
            if args.qk_reparam_type == 1:
                raise ValueError(
                    "--cga_no_freeze requires --qk_reparam_type 0: type 1's "
                    "quantizer freezes in-forward")
        elif self.cga_mode:
            cga_cfg = dict(bits=args.wq_bitw,
                           boundary_range=args.boundary_range,
                           qk_reparam=args.qk_reparam,
                           model_type=args.model_type)
        damp_cfg = None
        if getattr(args, "dampening_loss_weighting", 0.0) > 0:
            damp_cfg = dict(bits=args.wq_bitw,
                            weighting=args.dampening_loss_weighting)
        step = make_train_step(
            self.model, tx, teacher=self.teacher, loss_kind=self.loss_kind,
            label_smoothing=args.smoothing, device=self.device,
            ema_decay=args.model_ema_decay if args.model_ema else None,
            cga=cga_cfg, oscillation=osc_cfg, token_kd_alpha=args.kd_alpha,
            token_kd_type=args.kd_type, dampening=damp_cfg,
            master_dtype=master_dtype,
            per_layer_grad_norms=getattr(args, "wandb_watch", False))
        eval_step = make_eval_step(self.model)

        mgr = make_manager(self.out_dir, max_to_keep=args.checkpoint_hist,
                           metric_name=args.eval_metric)
        restored, start_epoch = restore_latest(mgr, state, self.model)
        if restored is not None:
            _logger.info("auto-resumed from epoch %d", start_epoch)
        # a recovery snapshot ahead of the last full epoch restarts that
        # epoch's data pass with the later step's state
        rec_dir = os.path.join(self.out_dir, "recovery")
        if os.path.isdir(rec_dir):
            rec_mgr = make_manager(rec_dir, max_to_keep=2)
            rec_step = rec_mgr.latest_step()
            if rec_step is not None and \
                    rec_step > start_epoch * steps_per_epoch:
                restore_into(load(rec_mgr, rec_step), state, self.model)
                start_epoch = rec_step // steps_per_epoch
                _logger.info(
                    "resumed from recovery snapshot at step %d (restarting "
                    "epoch %d)", rec_step, start_epoch)
        # CGA: a fixed window (cga.py:760,835); resume never extends it
        num_epochs = (args.freeze_for_n_epochs if self.cga_mode
                      else args.epochs + args.cooldown_epochs)

        gen = torch.Generator(device=self.device).manual_seed(args.seed)
        mix_gen = torch.Generator(device=self.device).manual_seed(
            args.seed + 1)
        summary_path = os.path.join(self.out_dir, "summary.csv")
        best = {"top1": -1.0, "epoch": -1}
        # the global optimizer step, carried by the checkpoint
        total_steps = int(state.step)
        # mid-epoch resume: skip the restarted epoch's consumed steps
        resume_it = total_steps % steps_per_epoch
        prof_n = getattr(args, "profile_steps", 0) or 0
        prof_start = total_steps + 5
        if prof_n and args.max_steps:
            prof_start = max(min(prof_start, args.max_steps - prof_n),
                             total_steps)
        batch = next(train_it)
        mixup_on = args.mixup > 0 or args.cutmix > 0

        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            losses = []
            it0 = resume_it if epoch == start_epoch else 0
            for it in range(it0, steps_per_epoch):
                dev_batch = self._device_batch(batch)
                if mixup_on:
                    dev_batch = mixup_cutmix(
                        dev_batch, mix_gen, mixup_alpha=args.mixup,
                        cutmix_alpha=args.cutmix, prob=args.mixup_prob,
                        switch_prob=args.mixup_switch_prob,
                        num_classes=args.num_classes,
                        label_smoothing=args.smoothing)
                    dev_batch["label"] = dev_batch.pop("soft_label")
                if prof_n and total_steps == prof_start:
                    from ..utils.profiling import Trace

                    self._prof = Trace(os.path.join(self.out_dir,
                                                    "trace")).start()
                state, metrics = step(state, dev_batch, gen)
                total_steps += 1
                if self._prof is not None and \
                        total_steps >= prof_start + prof_n:
                    self._stop_profiler()
                if it % args.log_interval == 0:
                    loss = float(metrics["loss"])
                    losses.append(loss)
                    osc = ""
                    if "oscillation/ema_mean" in metrics:
                        osc = " osc_ema %.5f" % float(
                            metrics["oscillation/ema_mean"])
                    _logger.info("epoch %d step %d/%d loss %.4f lr %.3e%s",
                                 epoch, it, steps_per_epoch, loss,
                                 float(lr_epoch(epoch)), osc)
                    if wandb is not None:
                        wandb.log({"step": total_steps,
                                   **{k: float(v)
                                      for k, v in metrics.items()}})
                if args.recovery_interval and \
                        total_steps % args.recovery_interval == 0:
                    self._save_recovery(total_steps, state)
                if self._preempted:
                    break
                if args.max_steps and total_steps >= args.max_steps:
                    break
                batch = next(train_it)

            if self._preempted:
                self._stop_profiler()
                just_saved = bool(args.recovery_interval and total_steps
                                  % args.recovery_interval == 0)
                wrote = (self._save_recovery(total_steps, state)
                         if not just_saved else True)
                _logger.warning(
                    "preempted at epoch %d step %d: recovery snapshot %s, "
                    "exiting", epoch, total_steps,
                    "saved" if wrote
                    else "already present (prior run, same step)")
                return best

            eval_metrics = self.evaluate(eval_step, None)
            if args.model_ema and state.ema_params is not None:
                # the EMA weights are validated too and their metric drives
                # the retention (train.py:830-836)
                eval_metrics = self.evaluate(eval_step, state.ema_params)
                _logger.info("epoch %d EMA: top1 %.3f", epoch,
                             eval_metrics["top1"])
            dt = time.time() - t0
            _logger.info("epoch %d done in %.1fs: top1 %.3f top5 %.3f",
                         epoch, dt, eval_metrics["top1"],
                         eval_metrics["top5"])
            save_epoch(mgr, epoch, state, eval_metrics,
                       buffers=dict(self.model.named_buffers()))
            write_header = not os.path.exists(summary_path)
            with open(summary_path, "a", newline="") as f:
                w = csv.writer(f)
                if write_header:
                    w.writerow(["epoch", "train_loss", "top1", "top5", "lr",
                                "seconds"])
                w.writerow([epoch, np.mean(losses) if losses else "",
                            eval_metrics["top1"], eval_metrics["top5"],
                            float(lr_epoch(epoch)), round(dt, 1)])
            if eval_metrics["top1"] > best["top1"]:
                best = {"top1": eval_metrics["top1"], "epoch": epoch}
            if wandb is not None:
                wandb.log({"epoch": epoch, **eval_metrics,
                           "lr": float(lr_epoch(epoch))})
            if args.max_steps and total_steps >= args.max_steps:
                break
        _logger.info("best top1 %.3f at epoch %d", best["top1"],
                     best["epoch"])
        return best

    # ------------------------------------------------------------ eval
    def evaluate(self, eval_step, params) -> dict:
        """top-1, top-5 and the mean loss over the validation stream;
        `params` (by name) replace the model's, None evaluates it as it
        stands.  The counts accumulate on the device: one host fetch."""
        totals = None
        eval_cfg = dataclasses.replace(self.data_cfg, seed=self.args.seed)
        for batch in make_dataset(eval_cfg, train=False):
            out = eval_step(params, self._device_batch(batch))
            out = torch.stack([out[k].to(torch.float64) for k in
                               ("correct1", "correct5", "count",
                                "loss_sum")])
            totals = out if totals is None else totals + out
        if totals is None:
            return {"top1": 0.0, "top5": 0.0, "loss": float("nan")}
        c1, c5, count, loss_sum = totals.tolist()
        n = max(count, 1.0)
        return {"top1": 100.0 * c1 / n, "top5": 100.0 * c5 / n,
                "loss": loss_sum / n}

    def evaluate_only(self) -> dict:
        """eval.py's counterpart: build, load `--resume` (an experiment
        directory, its EMA weights when it trained with --model-ema; an
        original-layout `.pth.tar`; or a pickle of the Flax params tree),
        validate."""
        args = self.args
        first = next(iter(make_dataset(self.data_cfg, train=False)))
        variables = self.calibrate_init(first)
        if args.resume and os.path.isdir(args.resume):
            variables, loaded = self.restore_experiment_params(
                args.resume, variables, use_ema=None, return_loaded=True)
            self.recalibrate_scales(variables, loaded, first)
        elif args.resume:
            args.initial_checkpoint = args.resume
            self.load_pretrained(variables, calib_batch=first)
        metrics = self.evaluate(make_eval_step(self.model), None)
        _logger.info("eval: top1 %.3f top5 %.3f loss %.4f", metrics["top1"],
                     metrics["top5"], metrics["loss"])
        return metrics
