"""One rank of `tests/test_torch_tensor_parallel.py`'s runs over gloo on the
CPU (imports the port, never JAX).

  python tp_worker.py steps <setup.pt> <out_dir>
  python tp_worker.py all <setup.pt> <out_dir>

with torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` in
the environment and the setup's `model_parallel`.  `steps` calibrates the
small DeiT W2A2 QKR student, shards it, runs the eval forward on this
rank's rows, then takes one step (or a case's `steps`) of each case of
the setup from the calibrated start (the composed, fused, pallas and int8
configurations on the kernels' plain versions, dropout, CGA, the step's
options: the telemetry losses, the EMA, clipping, bf16 masters, the
oscillation hook, per-layer gradient norms, the dampening loss; block
remat and the checkpointed tail, BatchNorm, the float student, 32-bit
sites, an unquantized softmax, the prelu and rprelu MLPs), gathers
what it computed, writes and restores checkpoints; then the same for each of the setup's
`configs` (the Swin students with and without QKR, DeiT-T's 3 heads, the
DeiT student without QKR: each a setup of its own, with its model's
`name` and `dims`).  `all` also fits the DeiT and Swin students through
the `Runner` with `--mesh-model-parallel` and evaluates the checkpoints
through `cli.eval.main`, and fits the DeiT student with the setup's
`option_fits` (the int8 core with the step's options; full-LSQ weights).  A setup's `faults` ({fault: case}) also take
that case's step with one of FAULTS planted.  Each rank writes its results to
`<out_dir>/<what>.rank<r>.pt`.  The test's own process calls `run_case`
and `calibrated_start` with `mesh=None` for the single process's results
on the global batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from ofq_tpu_torch.calibrate import calibrate  # noqa: E402
from ofq_tpu_torch.models import create_model  # noqa: E402
from ofq_tpu_torch.models import deit as deit_models  # noqa: E402
from ofq_tpu_torch.models import swin as swin_models  # noqa: E402
from ofq_tpu_torch.nn import dropout as dropout_mod  # noqa: E402
from ofq_tpu_torch.nn import quantizers  # noqa: E402
from ofq_tpu_torch.parallel import (host_batch_slice,  # noqa: E402
                                    initialize_multihost, make_mesh,
                                    shard_model, shard_params)
from ofq_tpu_torch.parallel.tensor import copy_to_model  # noqa: E402
from ofq_tpu_torch.quant import QuantPolicy, statsq_scale  # noqa: E402
from ofq_tpu_torch.quant.lsq import lsq_quantize  # noqa: E402
from ofq_tpu_torch.quant.ste import at_least_f32  # noqa: E402
from ofq_tpu_torch.train import (TrainState, constant_lr,  # noqa: E402
                                 cosine_with_warmup_cooldown, freeze_masks,
                                 make_optimizer, make_train_step)
from ofq_tpu_torch.train import checkpoint  # noqa: E402
from ofq_tpu_torch.train import loop as loop_mod  # noqa: E402
from ofq_tpu_torch.train import losses  # noqa: E402
from ofq_tpu_torch.train.optim import clip_gradients  # noqa: E402
from ofq_tpu_torch.train.oscillation_hook import (  # noqa: E402
    init_oscillation_states)

NAME = "deit_test_distilled"
# the small student of the tests: 4 heads, so that 2 model ranks split them
DIMS = dict(embed_dim=32, num_heads=4, num_classes=10)
DTYPES = {"float64": torch.float64, "float32": torch.float32}


SWIN = "swin_test"
# the small Swin of the tests: a 3-head stage, which 2 model ranks do not
# divide (its attention stays whole), and a 4-head one; 2 x 2 windows, so
# that both stages' second blocks are shifted
SWIN_DIMS = dict(num_heads=(3, 4), depths=(2, 2), window_size=2,
                 num_classes=10)


def small_variant():
    """`deit_test_distilled` at DIMS and `swin_test` at SWIN_DIMS, in the
    port's variant tables (the runner builds its models by name)."""
    deit_models.VARIANTS[NAME] = dataclasses.replace(
        deit_models.VARIANTS[NAME], **DIMS)
    swin_models.VARIANTS[SWIN] = dataclasses.replace(
        swin_models.VARIANTS[SWIN], **SWIN_DIMS)


# faults in the backward of the softmax scales whose input is cut on the
# head axis (`LsqAct.tp` axis 1): ds left this rank's heads' partial sum
# (no f; the ranks then differ), or the LSQ grad-scale factor counting
# this rank's heads (f kept; the same wrong gradient on every rank)
FAULTS = ("softmax_ds_unreduced", "softmax_grad_scale_local_heads")
# a row-parallel full-LSQ kernel's weight-scale grad-scale factor at its
# slice's shape (the same wrong gradient on every rank); the dampening
# loss's whole kernels counted once per rank (summed over the group with
# the sliced ones)
OPTION_FAULTS = ("lsq_weight_grad_scale_local", "dampening_whole_per_rank")


def _dampening_whole_per_rank(params, bits, weighting=0.0, layout=None):
    from ofq_tpu_torch.parallel.tensor import reduce_from_model
    from ofq_tpu_torch.quant.statsq import statsq_quantize
    total = 0.0
    for name, w in params.items():
        parts = name.split(".")
        if parts[-1] == "kernel" and any(n in losses._DAMPENED
                                         for n in parts):
            cut = layout.cuts.get(name)
            row = layout.mesh if cut is not None and cut.row_parallel \
                else None
            wq = statsq_quantize(w, bits, mesh=row).detach()
            s = statsq_scale(w, mesh=row)
            total = total + torch.sum((wq - losses._clip(
                w, -s, s * (1.0 - losses._CLIP_HI_EPS))) ** 2)
    return weighting * reduce_from_model(total, layout.mesh)


@contextlib.contextmanager
def planted(fault):
    """One of FAULTS or OPTION_FAULTS in effect."""
    if fault == "dampening_whole_per_rank":
        real = loop_mod.dampening_loss
        loop_mod.dampening_loss = _dampening_whole_per_rank
        try:
            yield
        finally:
            loop_mod.dampening_loss = real
        return
    if fault == "lsq_weight_grad_scale_local":
        real_w = quantizers.LsqWeight.forward

        def weight_forward(self, w):
            if self.tp is None:
                return real_w(self, w)
            s = copy_to_model(self.s, self.tp[1])
            return lsq_quantize(w.to(at_least_f32(w.dtype)), s, self.bit,
                                all_positive=self.all_positive,
                                channel_axis=self.axis, weight=True
                                ).to(w.dtype)

        quantizers.LsqWeight.forward = weight_forward
        try:
            yield
        finally:
            quantizers.LsqWeight.forward = real_w
        return
    real = quantizers.LsqAct.forward

    def forward(self, x):
        if self.tp is None or self.tp[0] != 1:
            return real(self, x)
        axis, mesh = self.tp
        s, model = self.s, (axis, mesh.model_parallel)
        if fault == "softmax_grad_scale_local_heads":
            s, model = copy_to_model(s, mesh), None
        return lsq_quantize(x, s, self.bit, all_positive=self.all_positive,
                            channel_axis=self.channel_axis, model=model)

    assert fault in FAULTS
    quantizers.LsqAct.forward = forward
    try:
        yield
    finally:
        quantizers.LsqAct.forward = real


class Recording:
    """The optimizer, recording the gradients it is handed and, with its
    clipping, the clipped ones."""

    def __init__(self, opt):
        self.opt, self.grads, self.clipped = opt, None, None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, state, params, **kw):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        if self.opt.clip_grad is not None:
            self.clipped = clip_gradients(grads, params, self.opt.clip_grad,
                                          self.opt.clip_mode, **kw)
        return self.opt.update(grads, state, params, **kw)


def _lr(spec):
    kind, base, kw = spec
    return (constant_lr(base) if kind == "constant"
            else cosine_with_warmup_cooldown(base, **kw))


def _model(setup, conf, policy=None, dtype=None):
    m = create_model(setup.get("name", NAME),
                     policy=policy or setup["policy"], device="cpu",
                     **setup.get("dims", DIMS), **conf)
    return m.to(DTYPES[dtype or setup["dtype"]])


def _load(m, setup, case, calibrated) -> None:
    """The case's start: the calibrated student, or the setup's tensors
    named by `case["start"]` (a float student's); with `case["extra"]`,
    the setup's tensors of that name over it (an RPReLU's shifts and
    slopes).  A case whose model differs from the calibrated one (`loose`:
    BatchNorm, an unquantized site, another activation) takes the
    tensors it has and keeps its initial values for the others."""
    sd = dict(setup[case["start"]] if "start" in case else calibrated)
    sd.update(setup.get(case.get("extra"), {}))
    if case.get("loose") or "start" in case or "extra" in case:
        own = m.state_dict()
        sd = {k: v for k, v in sd.items() if k in own}
        m.load_state_dict(sd, strict=False)
    else:
        m.load_state_dict(sd)


def _rows(batch: dict, mesh) -> dict:
    per, off = host_batch_slice(len(batch["label"]), mesh)
    return {k: torch.as_tensor(v)[off:off + per] for k, v in batch.items()}


def _gather(tensors, layout):
    return dict(tensors) if layout is None else layout.gather(tensors)


def _clone(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def calibrated_start(setup: dict, mesh=None) -> dict:
    """The student calibrated on the setup's batch (every rank calibrates
    the whole model), then sharded; the eval forward's logits on this
    rank's rows."""
    m = _model(setup, {})
    m.load_state_dict(setup["weights"])
    calibrate(m, setup["calib"])
    out = dict(calibrated=_clone(m.state_dict()))
    if mesh is not None and mesh.model_parallel > 1:
        shard_model(m, mesh)
    with torch.no_grad():
        out["logits"] = m(_rows(setup["batch"], mesh)["image"].to(
            DTYPES[setup["dtype"]]))
    return out


def run_case(setup: dict, case: dict, calibrated: dict, mesh=None,
             ckpt_dir=None) -> dict:
    """One step (`case["steps"]` steps) of `case` from `calibrated` with
    the setup's moments: what it computed, the full tensors (gathered),
    and this rank's own gradients (of the last step); with `ckpt_dir`, the
    sharded start written there as a checkpoint first.  A case may ask for
    an EMA (`ema`), bf16 masters (`master_dtype`), clipping (`clip`,
    `clip_mode`), the oscillation hook's states (`osc`, with the step's
    `oscillation`) and the eval logits of its start (`eval`)."""
    dt = case.get("dtype", setup["dtype"])
    m = _model(setup, case["conf"], case.get("policy"), dt)
    _load(m, setup, case, calibrated)
    teacher = _model(setup, case.get("teacher_conf", {}), QuantPolicy(), dt)
    teacher.load_state_dict(setup["teacher"])
    if case.get("teacher_bf16"):
        teacher.to(torch.bfloat16)
    opt = Recording(make_optimizer(_lr(case["lr"]), weight_decay=0.05,
                                   clip_grad=case.get("clip"),
                                   clip_mode=case.get("clip_mode", "norm")))
    state = TrainState.create(m, opt, ema=case.get("ema", False),
                              master_dtype=case.get("master_dtype"))
    cast = DTYPES[dt]
    # the setup's moments (`case["moments"]`: a prefix of their names) for
    # the parameters they cover, the state's zeros for the others
    pre = case.get("moments", "")
    mu, nu = setup[pre + "mu"], setup[pre + "nu"]
    state.opt_state = dataclasses.replace(
        state.opt_state, count=setup["start"],
        mu={k: mu[k].to(cast) if k in mu else v
            for k, v in state.opt_state.mu.items()},
        nu={k: nu[k].to(cast) if k in nu else v
            for k, v in state.opt_state.nu.items()})
    state.step = setup["start"]
    osc = case["step_kw"].get("oscillation")
    if osc is not None:
        state.extra = {"oscillation": init_oscillation_states(
            state.params, bits=osc["bits"], qk_reparam=osc["qk_reparam"],
            model_type=osc["model_type"])}
    if mesh is not None:
        state = shard_params(state, mesh, m)
    if ckpt_dir is not None:
        checkpoint.save_epoch(checkpoint.make_manager(ckpt_dir), 0, state,
                              {"top1": 0.0}, buffers=dict(m.named_buffers()))
    layout = state.tp
    masks = None
    if "cga" in case["step_kw"]:
        cga = case["step_kw"]["cga"]
        got = freeze_masks(state.params, bits=cga["bits"],
                           boundary_range=cga["boundary_range"],
                           qk_reparam=cga["qk_reparam"],
                           model_type=cga.get("model_type", "deit"),
                           layout=layout)
        masks = _gather({k: v for k, v in got.items() if v is not None},
                        layout)
    logits = None
    if case.get("eval"):
        m.eval()
        with torch.no_grad():
            logits = m(_rows(setup["batch"], mesh)["image"].to(cast))
    step = make_train_step(m, opt, teacher=teacher, device="cpu", mesh=mesh,
                           **{"loss_kind": "kd_soft_hard",
                              **case["step_kw"]})
    drawn = []
    real = dropout_mod.bernoulli

    def recorded(shape, keep, generator, shard=None):
        t = real(shape, keep, generator, shard=shard)
        drawn.append((t.clone(), None if shard is None else shard[0]))
        return t

    gen = (torch.Generator().manual_seed(case["seed"])
           if "seed" in case else None)
    dropout_mod.bernoulli = recorded
    history = []
    try:
        for _ in range(case.get("steps", 1)):
            state, met = step(state, _rows(setup["batch"], mesh), gen)
            history.append({k: float(v) for k, v in met.items()})
    finally:
        dropout_mod.bernoulli = real
    osc_states = (state.extra or {}).get("oscillation")
    if osc_states is not None and layout is not None:
        osc_states = layout.gather_states(osc_states)
    return dict(
        own_grads=opt.grads, grads=_gather(opt.grads, layout),
        params=_gather(_clone(state.params), layout),
        mu=_gather(state.opt_state.mu, layout),
        nu=_gather(state.opt_state.nu, layout),
        ema=(None if state.ema_params is None
             else _gather(state.ema_params, layout)),
        clipped=(None if opt.clipped is None
                 else _gather(_clone(opt.clipped), layout)),
        osc=(None if osc_states is None else
             {n: st._asdict() for n, st in osc_states.items()}),
        metrics=history[-1], history=history, logits=logits, masks=masks,
        drawn=drawn, buffers=_clone(dict(m.named_buffers())),
        cuts=[] if layout is None else sorted(layout.cuts),
        state=state, model=m)


def checkpoints(setup: dict, res: dict, out_dir: str, mesh) -> dict:
    """The sharded state after a step written as a checkpoint (rank 0,
    the slices gathered), read back into it; the single process's
    checkpoint (`setup["single_ckpt"]`) restored into it."""
    state, m = res["state"], res["model"]
    mgr = checkpoint.make_manager(os.path.join(out_dir, "ckpt_mp"))
    checkpoint.save_epoch(mgr, 0, state, {"top1": 1.0},
                          buffers=dict(m.named_buffers()))
    live = (_clone(state.params), _clone(state.opt_state.mu))
    with torch.no_grad():
        for t in state.params.values():
            t.zero_()
    checkpoint.restore_into(checkpoint.load(mgr, 0), state, m)
    back = all(torch.equal(state.params[k], v) for k, v in live[0].items())
    back &= all(torch.equal(state.opt_state.mu[k], v)
                for k, v in live[1].items())
    single = checkpoint.make_manager(setup["single_ckpt"])
    checkpoint.restore_into(checkpoint.load(single, 0), state, m)
    return dict(round_trip=back, dir=mgr.directory,
                start_dir=os.path.join(out_dir, "ckpt_start"),
                from_single=dict(params=_clone(state.params),
                                 mu=_clone(state.opt_state.mu)))


def run_config(setup: dict, out_dir: str, mesh) -> dict:
    """The calibrated start, the eval logits and every case's step of one
    setup; its checkpoint case also writes and reads checkpoints under
    `out_dir`."""
    start = calibrated_start(setup, mesh)
    out = dict(logits=start["logits"], calibrated=start["calibrated"],
               mesh=(mesh.data_index, mesh.model_index, mesh.data_world,
                     mesh.model_parallel))
    for name, case in setup["cases"].items():
        ckpt = name == setup["checkpoint_case"]
        res = run_case(setup, case, start["calibrated"], mesh,
                       ckpt_dir=(os.path.join(out_dir, "ckpt_start")
                                 if ckpt else None))
        if ckpt:
            out["checkpoints"] = checkpoints(setup, res, out_dir, mesh)
        if case.get("buffers_checkpoint"):
            # the file of a sharded BatchNorm student after its step: the
            # running statistics under one process's names
            mgr = checkpoint.make_manager(os.path.join(out_dir, f"ck_{name}"))
            checkpoint.save_epoch(mgr, 0, res["state"], {"top1": 0.0},
                                  buffers=dict(res["model"].named_buffers()))
            res["buffers_file"] = checkpoint.load(mgr, 0)["buffers"]
        del res["state"], res["model"]
        out[name] = res
    for fault, name in setup.get("faults", {}).items():
        with planted(fault):
            res = run_case(setup, setup["cases"][name], start["calibrated"],
                           mesh)
        out[fault] = dict(grads=res["grads"], own_grads=res["own_grads"],
                          metrics=res["metrics"])
    return out


def steps(setup: dict, out_dir: str, mesh) -> None:
    out = run_config(setup, out_dir, mesh)
    # the group's StatsQ scale from this rank's rows of a kernel
    w = torch.from_numpy(setup["kernel"])
    n = w.shape[0] // mesh.model_parallel
    rows = w[mesh.model_index * n:(mesh.model_index + 1) * n]
    out["scale"] = (statsq_scale(w), statsq_scale(rows, mesh=mesh))
    out["configs"] = {
        key: run_config(conf, os.path.join(out_dir, key), mesh)
        for key, conf in setup.get("configs", {}).items()}
    torch.save(out, os.path.join(out_dir, f"steps.rank{mesh.rank}.pt"))


def runner(setup: dict, out_dir: str, mesh) -> None:
    from ofq_tpu_torch.cli import common
    from ofq_tpu_torch.cli import eval as cli_eval
    from ofq_tpu_torch.cli.runner import Runner
    small_variant()
    r = Runner(common.parse_args(setup["fit"]), device="cpu")
    best = r.fit()
    out = dict(best=best, batch=r.data_cfg.batch_size,
               shard=(r.data_cfg.shard_index, r.data_cfg.shard_count),
               params={k: v.detach().clone()
                       for k, v in r.model.named_parameters()})
    out["eval"] = cli_eval.main(setup["eval"], device="cpu")
    from ofq_tpu_torch.cli import train as cli_train
    out["option_fits"] = {k: cli_train.main(argv, device="cpu")
                          for k, argv in setup.get("option_fits", {}).items()}
    if "swin" in setup:
        from ofq_tpu_torch.cli import cga as cli_cga
        sw = setup["swin"]
        out["swin"] = dict(train=cli_train.main(sw["fit"], device="cpu"),
                           cga=cli_cga.main(sw["cga"], device="cpu"),
                           eval=cli_eval.main(sw["eval"], device="cpu"))
    torch.save(out, os.path.join(out_dir, f"runner.rank{mesh.rank}.pt"))


def main(mode: str, setup_path: str, out_dir: str) -> None:
    initialize_multihost(device="cpu")  # gloo, from the environment
    setup = torch.load(setup_path, weights_only=False)
    mesh = make_mesh(model_parallel=setup["model_parallel"], device="cpu")
    steps(setup, out_dir, mesh)
    if mode == "all":
        runner(setup, out_dir, mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(*sys.argv[1:4])
