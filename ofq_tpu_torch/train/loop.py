"""The QAT train step and the eval step (port of
`ofq_tpu/train/loop.py:25-223`).

One step, in JAX's order: the student forward in train mode (distilled:
`(cls, dist)` logits; the image quantizer's sticky sign updates), the
float teacher forward in eval mode under `torch.no_grad()`, the loss plus
the optional dampening term, the backward through every STE and kernel,
then, with `cga`, the freeze masks from the pre-update masters and the
masked gradients, the optional clipping and AdamW on the >= fp32 view,
the update added in >= fp32 and cast to the masters' dtype, the frozen
entries restored, and the EMA of the result.  Eager PyTorch, no host
synchronisation: the metrics come back as device tensors.

bf16 master weights (a state from `TrainState.create(...,
master_dtype="bfloat16")`; the step reads the masters' dtype from the
state): the state holds the bf16 masters and the model fp32 working
parameters, which each step fills from the masters (an exact upcast) and
which carry the forward.  The gradients are rounded to bf16 (the transpose
of JAX's upcast inside its loss), the update math runs in fp32 and its
result is rounded to bf16.  With fp32 masters the update is added in place.

Dropout and drop-path: `train_step(state, batch, generator)` takes the
counterpart of JAX's `rng`, a `torch.Generator` on the model's device (a
CUDA generator on the card), and hands it to the student's forward for
that call only; every mask of the step is drawn from it, in the forward's
order (`nn/dropout.py`), and the teacher, in eval mode, draws nothing.  A
student with a rate above 0 and no generator raises; the step draws no
random number from any other stream.  DeiT and Swin students go through
the same step (Swin: non-distilled logits, the CGA selection with
`model_type="swin"`).

The distillation losses with telemetry take the models' `aux` (`forward(x,
generator, aux=True)`): `kd_qk` and `kd_qkv` the attentions' Grams
(student and teacher built with `qqkkvv=True`), `kd_token` the token
features (`return_features=True`, with `token_kd_alpha` and
`token_kd_type`); the teacher's run under `torch.no_grad()`.

The oscillation hook (`oscillation=dict(bits, momentum, freeze_threshold,
qk_reparam, model_type)`, with the tracking state in `state.extra`, from
`oscillation_hook.init_oscillation_states`) runs after AdamW and the CGA
restore and before the EMA, as in JAX: the states update from the new
masters and, with `freeze_threshold > 0`, the frozen entries are pinned
(under bf16 masters the pinned masters are copied into the working
parameters too).  `per_layer_grad_norms` adds `grad_norm/<name>` for each
top-level name (the first component of the parameter names: `blocks_0`,
`cls_token`, `head`, ...) over the masked gradients.  A BatchNorm
student's running statistics update in its train-mode forward, once per
step (also under remat); they take no gradient, AdamW, CGA or EMA, and
`make_eval_step` normalizes with them.

Data parallelism (`mesh`, from `parallel.make_mesh` in a process group):
each rank takes its rows of the global batch, and the step computes the
JAX package's step on the global batch (GSPMD's reductions written out,
`parallel/collectives.py`).  The forward and backward run in
`collectives.data_parallel(mesh)`, where the LSQ gradient scales take the
global batch's shape, BatchNorm the global statistics, the dropout masks
the global draw and the image quantizer the global sign; between
`torch.autograd.grad` and everything that reads the gradients (the CGA
masks, clipping, AdamW, the per-layer norms, the oscillation hook) the
gradients are averaged over the ranks, so every rank applies the same
update to the same state.  The reported `loss` is the global mean (the
runner sums `make_eval_step`'s counts over the ranks).

Tensor parallelism (a `mesh` with `model_parallel` > 1, the model sharded
by `parallel.shard_model`, the state by `parallel.shard_params`): the
ranks of a model group take the same rows and hold slices of the model;
the collectives of the 'model' axis run inside the forward and backward
(`parallel/tensor.py`), so every gradient leaves the backward complete
(a sliced parameter's slice of the full gradient, a whole parameter's
whole gradient, bit-equal on every model rank); the gradient mean runs
over the data group only, AdamW elementwise on the slices, CGA's masks
on the slices with the whole kernels' scales and level ranges, and
`grad_norm` is the norm of the full gradients.  The loss and metrics are
the same on every model rank.  Every configuration `shard_model` takes
runs there: under remat the replayed blocks reissue the model group's
collectives in the backward, in the same order on every rank; a
BatchNorm's statistics reduce over the data group only (the model
group's ranks see the same rows) and move alike on every model rank.
Every option runs there: the telemetry losses and the dampening term
reduce over the model group inside the loss (`losses.py`); the clipping
reads the full gradients (`optim.py`); the EMA and bf16 masters are
elementwise on the slices; the oscillation hook reads a row-parallel
kernel's codes at the whole kernel's scale and its `ema_mean` counts
every entry once, as do `per_layer_grad_norms`.

`kd_qk` and `kd_qkv` over a data axis wider than 1: the Grams' norms
span the global batch, so their squared sums are reduced over the data
group inside the loss (`losses.gram_matching`) and every rank holds the
global Gram term; its gradient is taken at the data group's size times
the term (each rank's rows hold their share of it, and the gradient mean
divides by that size), while the reported loss adds the term once.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..models.registry import resolve_device
from ..nn.dropout import check_generator
from ..parallel import collectives
from ..quant.ste import at_least_f32
from . import cga as cga_lib
from . import oscillation_hook as osc_lib
from .losses import (dampening_loss, gram_matching, hard_ce,
                     kd_soft_and_hard, kl_token_mse, soft_ce)
from .optim import AdamW, ema_update, global_norm
from .state import TrainState

LOSS_KINDS = ("ce", "kd_soft", "kd_soft_hard", "kd_qk", "kd_qkv", "kd_token")
# the losses that read the models' aux (Grams or token features)
AUX_LOSS_KINDS = ("kd_qk", "kd_qkv", "kd_token")


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _tensor(a, device, dtype=None):
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    return t.to(device) if dtype is None else t.to(device, dtype)


def _cga_settings(cga: dict, policy) -> dict:
    """`freeze_masks`' keywords from `cga`, whose `boundary_range` and
    `qk_reparam` default to the policy's (the recipe sets both from one
    flag) and must agree with it."""
    out = dict(bits=cga["bits"], model_type=cga.get("model_type", "deit"))
    for key in ("boundary_range", "qk_reparam"):
        pol = getattr(policy, key, None)
        val = cga.get(key, pol)
        if val is None:
            raise ValueError(f"cga needs {key!r}: the model has no policy")
        if pol is not None and val != pol:
            raise ValueError(f"cga[{key!r}]={val!r}, but the model's policy "
                             f"has {key}={pol!r}")
        out[key] = val
    return out


def _oscillation_settings(oscillation: dict) -> dict:
    """The hook's keywords, with JAX's defaults; `bits` is required."""
    if "bits" not in oscillation:
        raise ValueError("oscillation needs 'bits'")
    return dict(bits=oscillation["bits"],
                momentum=oscillation.get("momentum", 0.01),
                freeze_threshold=oscillation.get("freeze_threshold", 0.0),
                qk_reparam=oscillation.get("qk_reparam", False),
                model_type=oscillation.get("model_type", "deit"))


def _per_layer_norms(grads: dict, layout=None) -> dict:
    """`grad_norm/<top-level name>` over each group of gradients (of the
    full gradients with a tensor-parallel `layout`)."""
    groups = {}
    for n, g in grads.items():
        groups.setdefault(n.split(".")[0], {})[n] = g
    return {f"grad_norm/{k}": (global_norm(v.values()) if layout is None
                               else layout.global_norm(v))
            for k, v in groups.items()}


def make_train_step(model: torch.nn.Module, optimizer: AdamW, *,
                    teacher: Optional[torch.nn.Module] = None,
                    loss_kind: str = "kd_soft_hard",
                    label_smoothing: float = 0.0, device="cuda",
                    ema_decay: Optional[float] = None,
                    cga: Optional[dict] = None, oscillation=None,
                    token_kd_alpha: float = 0.5, token_kd_type: str = "last",
                    dampening: Optional[dict] = None,
                    master_dtype: Optional[str] = None,
                    per_layer_grad_norms: bool = False,
                    mesh=None) -> Callable:
    """Build `train_step(state, batch, generator=None) -> (state,
    metrics)`.

    `batch` is {"image": (B, H, W, 3) NHWC, "label": (B,) class ids}, as
    numpy arrays or tensors; `metrics` holds `loss` and `grad_norm` (of
    the masked gradients).  `generator` draws the student's dropout and
    drop-path masks; it must be given, on the model's device, when the
    model has a rate above 0.  `cga` is dict(bits, boundary_range,
    qk_reparam, model_type): `boundary_range` and `qk_reparam` default to
    the model's policy's and must agree with it.  `dampening` is
    dict(bits, weighting); with `ema_decay` the state must hold an EMA
    (`TrainState.create(..., ema=True)`).  `token_kd_alpha` and
    `token_kd_type` are `kd_token`'s (`kl_token_mse`).  `oscillation` is
    dict(bits, momentum=0.01, freeze_threshold=0.0, qk_reparam=False,
    model_type="deit"); the hook runs when the state holds
    `extra["oscillation"]` (as in JAX, a state without it skips the
    hook) and adds `oscillation/ema_mean` to the metrics.
    `per_layer_grad_norms` adds `grad_norm/<top-level name>`.
    `master_dtype` is the JAX step's option, checked against the state's
    masters at each step.  `mesh` (`parallel.make_mesh`): `batch` is this
    rank's rows of the global batch, the step the global batch's (module
    docstring); None is the single-process step.
    Runs on CUDA unless `device="cpu"`; the model (and teacher) must
    already live there.
    """
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"loss_kind={loss_kind!r}: one of {LOSS_KINDS}")
    if oscillation is not None:
        oscillation = _oscillation_settings(oscillation)
    if master_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"master_dtype={master_dtype!r}")
    if cga is not None:
        cga = _cga_settings(cga, getattr(model, "policy", None))
    if loss_kind != "ce" and teacher is None:
        raise ValueError(f"loss_kind={loss_kind!r} needs a teacher")
    dev = resolve_device(device)
    work = dict(model.named_parameters())
    if any(p.dtype not in (torch.float32, torch.float64)
           for p in work.values()):
        raise ValueError("the model's parameters must be fp32 or fp64; for "
                         "bf16 masters keep them in the state "
                         "(TrainState.create(..., master_dtype='bfloat16'))")
    p0 = next(iter(work.values()))
    if p0.device.type != dev.type:
        raise ValueError(f"the model lives on {p0.device}, not on {dev}")
    if dampening is not None and dampening.get("weighting", 0.0) <= 0:
        dampening = None
    cfg = getattr(model, "cfg", None)
    draws = cfg is not None and max(cfg.drop_rate, cfg.attn_drop_rate,
                                    cfg.drop_path_rate) > 0
    layout = None
    if mesh is not None and mesh.model_parallel > 1:
        layout = getattr(model, "tp_layout", None)
        if layout is None:
            raise ValueError("model_parallel > 1: shard the model first "
                             "(parallel.shard_params / shard_model)")
        if cga is not None:
            # the masks of the whole kernels, on this rank's slices
            cga = dict(cga, layout=layout)

    aux = loss_kind in AUX_LOSS_KINDS
    # the Gram term is global: every rank of a data group holds it whole,
    # and the gradient mean over the group divides its rows' shares
    gram_weight = 1 if mesh is None else mesh.data_world
    # the optimizer's clipping reads the full gradients under TP
    opt_kw = {} if layout is None else {"layout": layout}

    def loss_fn(x, label, generator):
        """(the loss to differentiate, the loss to report)."""
        out = model(x, generator, aux=True) if aux else model(x, generator)
        out, info = out if aux else (out, None)
        reported = None
        if loss_kind == "ce":
            loss = hard_ce(_first(out), label, label_smoothing)
        else:
            with torch.no_grad():
                t_out = teacher(x, aux=True) if aux else teacher(x)
                t_out, t_info = t_out if aux else (t_out, None)
                t_logits = _first(t_out)
            if loss_kind == "kd_soft":
                loss = soft_ce(_first(out), t_logits)
            elif loss_kind == "kd_soft_hard":
                loss = kd_soft_and_hard(out, label, t_logits)
            elif loss_kind == "kd_token":
                loss = kl_token_mse(_first(out), info["features"], t_logits,
                                    t_info["features"], alpha=token_kd_alpha,
                                    kd_type=token_kd_type)
            else:
                base = kd_soft_and_hard(out, label, t_logits)
                gram = gram_matching(info, t_info,
                                     include_v=loss_kind == "kd_qkv",
                                     mesh=mesh)
                loss = base + gram
                if gram_weight > 1:
                    reported = loss
                    loss = base + gram_weight * gram
        if dampening is not None:
            damp = dampening_loss(work, dampening["bits"],
                                  dampening["weighting"], layout)
            loss = loss + damp
            if reported is not None:
                reported = reported + damp
        return loss, loss if reported is None else reported

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None):
        x = _tensor(batch["image"], p0.device, p0.dtype)
        if draws or generator is not None:
            check_generator(x, generator, "the student's dropout and "
                            "drop-path")
        model.train()
        if teacher is not None:
            teacher.eval()
        label = _tensor(batch["label"], p0.device)
        names = list(state.params)
        masters = [state.params[n] for n in names]
        master_bf16 = masters[0].dtype == torch.bfloat16
        if master_dtype is not None and master_bf16 != (
                master_dtype == "bfloat16"):
            raise ValueError(f"master_dtype={master_dtype!r}, but the "
                             f"state's masters are {masters[0].dtype}")
        if layout is not None and state.tp is not layout:
            raise ValueError("the state is not the sharded model's "
                             "(parallel.shard_params)")
        if master_bf16:
            tensors = [work[n] for n in names]
            with torch.no_grad():
                torch._foreach_copy_(tensors, masters)
        else:
            tensors = masters
        with collectives.data_parallel(mesh):
            loss, reported = loss_fn(x, label, generator)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        # a parameter the loss does not reach (a detached scale) has a
        # zero gradient, as under jax.grad
        grads = {n: torch.zeros_like(t) if g is None else g
                 for n, t, g in zip(names, tensors, grads)}
        with torch.no_grad():
            # GSPMD's gradient all-reduce: the mean over the ranks
            grads = collectives.all_reduce_mean(grads, mesh)
            loss = collectives.all_reduce_mean({"loss": reported.detach()},
                                               mesh)["loss"]
            if master_bf16:
                grads = {n: g.to(torch.bfloat16) for n, g in grads.items()}
            # the >= fp32 view of the pre-update masters
            views = dict(zip(names, tensors))
            masks = None
            if cga is not None:
                masks = cga_lib.freeze_masks(views, **cga)
                grads = cga_lib.mask_grads(grads, masks)
            updates, opt_state = optimizer.update(
                {n: g.to(at_least_f32(g.dtype)) for n, g in grads.items()},
                state.opt_state, views, **opt_kw)
            frozen = [] if masks is None else [
                n for n in names if masks[n] is not None]
            # the selected fp32 masters as they were, for the restore
            old = ({n: views[n].clone() for n in frozen} if not master_bf16
                   else state.params)
            torch._foreach_add_(tensors, [updates[n] for n in names])
            if master_bf16:
                new = {n: t.to(torch.bfloat16) for n, t in zip(names, tensors)}
                if masks is not None:
                    new = cga_lib.restore_frozen(old, new, masks)
                torch._foreach_copy_(masters, [new[n] for n in names])
                torch._foreach_copy_(tensors, masters)
            elif frozen:
                new = cga_lib.restore_frozen(
                    old, {n: views[n] for n in frozen}, masks)
                torch._foreach_copy_([views[n] for n in frozen],
                                     [new[n] for n in frozen])
            osc_metrics = {}
            if oscillation is not None and state.extra is not None:
                osc_metrics = _oscillation_step(state, tensors, names,
                                                master_bf16)
            if ema_decay is not None and state.ema_params is not None:
                state.ema_params = ema_update(state.ema_params, state.params,
                                              ema_decay)
        state.opt_state = opt_state
        state.step += 1
        metrics = {"loss": loss.detach(),
                   "grad_norm": (global_norm(grads.values()) if layout is None
                                 else layout.global_norm(grads))}
        if per_layer_grad_norms:
            metrics.update(_per_layer_norms(grads, layout))
        metrics.update(osc_metrics)
        return state, metrics

    def _oscillation_step(state, tensors, names, master_bf16):
        """The hook on the updated masters, in place: the states into
        `state.extra`, the pinned entries into the masters (and the
        working parameters under bf16 masters); returns its metrics."""
        o = oscillation
        kw = dict(bits=o["bits"], qk_reparam=o["qk_reparam"],
                  model_type=o["model_type"])
        osc, met = osc_lib.update_oscillation_states(
            state.params, state.extra["oscillation"], momentum=o["momentum"],
            freeze_threshold=o["freeze_threshold"], layout=layout, **kw)
        state.extra = {**state.extra, "oscillation": osc}
        if o["freeze_threshold"] > 0:
            pinned = osc_lib.apply_frozen(state.params, state.params, osc,
                                          layout=layout, **kw)
            tracked = [n for n in names if n in osc]
            torch._foreach_copy_([state.params[n] for n in tracked],
                                 [pinned[n] for n in tracked])
            if master_bf16:
                idx = {n: i for i, n in enumerate(names)}
                torch._foreach_copy_([tensors[idx[n]] for n in tracked],
                                     [state.params[n] for n in tracked])
        return met

    return train_step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """Build `eval_step(params, batch) -> counts` for one batch: `correct1`
    and `correct5` (top-k hits, ties to the lower class as in JAX),
    `count` and `loss_sum` (the summed fp32
    cross-entropy), all over the rows whose label is >= 0 (a row with
    label -1 is padding and counts nothing), as device tensors.  `params`
    (by name: `state.params`, `state.ema_params`) replace the model's for
    the call, bf16 masters as fp32; None evaluates the model as it
    stands.  A BatchNorm model normalizes with its running statistics,
    the model's buffers, for any `params` (JAX's runner passes the full
    variables, the EMA's too)."""
    p0 = next(model.parameters())

    def eval_step(params, batch):
        model.eval()
        x = _tensor(batch["image"], p0.device, p0.dtype)
        label = _tensor(batch["label"], p0.device)
        with torch.no_grad():
            if params is None:
                logits = _first(model(x))
            else:
                logits = _first(functional_call(
                    model, {n: p.to(at_least_f32(p.dtype))
                            for n, p in params.items()}, (x,)))
            # equal logits rank the lower class first, as under
            # jax.lax.top_k (torch.topk leaves their order open)
            top = torch.sort(logits, dim=-1, descending=True,
                             stable=True).indices[:, :min(5, logits.shape[-1])]
            valid = label >= 0
            hit = (top == label[:, None]) & valid[:, None]
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            nll = -torch.gather(logp, -1,
                                label.clamp_min(0)[:, None].long())[:, 0]
            return {"correct1": hit[:, :1].sum(), "correct5": hit.sum(),
                    "count": valid.sum(), "loss_sum": torch.sum(nll * valid)}

    return eval_step
