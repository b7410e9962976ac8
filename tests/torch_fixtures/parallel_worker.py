"""One rank of `tests/test_torch_parallel.py`'s two-rank runs over gloo on
the CPU (imports the port, never JAX).

  python parallel_worker.py steps <setup.pkl> <out_dir>
  python parallel_worker.py runner <setup.pkl> <out_dir>

with torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT` in
the environment.  `steps` takes one train step of each case of the setup
on this rank's rows of its global batch (and the mixup pairs); `runner`
fits a tiny model through the `Runner` for one epoch, resumes it for a
second, and evaluates it on an ImageFolder through `cli.eval.main`.  Each
rank writes what it computed to `<out_dir>/<what>.rank<r>.pt`.  The
test's own process calls `run_step` and `run_mixup` with `mesh=None` for
the single-process results on the global batch.
"""

from __future__ import annotations

import os
import pickle
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from ofq_tpu_torch.convert import load_flax_params, load_optax_adamw_state  # noqa: E402
from ofq_tpu_torch.data import mixup_cutmix  # noqa: E402
from ofq_tpu_torch.data.pipeline import mixup_draws  # noqa: E402
from ofq_tpu_torch.models import create_model  # noqa: E402
from ofq_tpu_torch.nn import dropout as dropout_mod  # noqa: E402
from ofq_tpu_torch.parallel import (host_batch_slice,  # noqa: E402
                                    initialize_multihost, make_mesh)
from ofq_tpu_torch.quant import QuantPolicy  # noqa: E402
from ofq_tpu_torch.train import (TrainState, constant_lr,  # noqa: E402
                                 cosine_with_warmup_cooldown,
                                 make_optimizer, make_train_step)

DTYPES = {"float64": torch.float64, "float32": torch.float32}


class Recording:
    """The optimizer, recording the gradients it is handed (the step's
    all-reduced, masked gradients)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def _lr(spec):
    kind, base, kw = spec
    return (constant_lr(base) if kind == "constant"
            else cosine_with_warmup_cooldown(base, **kw))


def run_step(case: dict, batch: dict, mesh=None) -> dict:
    """One step of `case` (a model name, port policy, config, numpy
    variables, teacher variables, mid-run moments, step options) on
    `batch`: the parameters, buffers, gradients, moments and metrics
    after it, and the dropout masks it drew."""
    dt = DTYPES[case["dtype"]]
    port = create_model(case["name"], policy=case["policy"], device="cpu",
                        **case["conf"]).to(dt)
    load_flax_params(port, case["variables"])
    teacher = create_model(case["name"], policy=QuantPolicy(), device="cpu",
                           **case.get("teacher_conf", {})).to(dt)
    load_flax_params(teacher, case["tvars"]["params"])
    opt = Recording(make_optimizer(_lr(case["lr"]), weight_decay=0.05))
    state = TrainState.create(port, opt)
    load_optax_adamw_state(state, {"count": case["start"],
                                   "mu": case["mu"], "nu": case["nu"]},
                           step=case["start"])
    step = make_train_step(port, opt, teacher=teacher, device="cpu",
                           mesh=mesh, **{"loss_kind": "kd_soft_hard",
                                         **case.get("step_kw", {})})
    masks = []
    real = dropout_mod.bernoulli

    def recorded(shape, keep, generator):
        m = real(shape, keep, generator)
        masks.append(m.clone())
        return m

    gen = (torch.Generator().manual_seed(case["seed"])
           if "seed" in case else None)
    dropout_mod.bernoulli = recorded
    try:
        state, met = step(state, batch, gen)
    finally:
        dropout_mod.bernoulli = real
    return dict(
        params={k: v.detach().clone() for k, v in state.params.items()},
        buffers={k: v.clone() for k, v in port.named_buffers()},
        grads=opt.grads, masks=masks,
        mu={k: v.clone() for k, v in state.opt_state.mu.items()},
        nu={k: v.clone() for k, v in state.opt_state.nu.items()},
        metrics={k: float(v) for k, v in met.items()})


def run_mixup(batch: dict, seeds, mesh=None) -> list:
    """`mixup_cutmix` of `batch` with a generator of each seed: the mixed
    images, soft labels and whether it cut."""
    out = []
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        mixed = mixup_cutmix(dict(batch), gen, num_classes=10,
                             label_smoothing=0.1, mesh=mesh)
        draws = mixup_draws(torch.Generator().manual_seed(seed), height=1,
                            width=1)
        out.append(dict(image=mixed["image"], soft_label=mixed["soft_label"],
                        cut=bool(draws.use_cutmix)))
    return out


def _rows(batch: dict) -> dict:
    per, off = host_batch_slice(len(batch["label"]))
    return {k: torch.as_tensor(v)[off:off + per] for k, v in batch.items()}


def steps(setup: dict, out_dir: str, mesh) -> None:
    for name, case in setup["cases"].items():
        res = run_step(case, _rows(case["batch"]), mesh)
        torch.save(res, os.path.join(out_dir, f"{name}.rank{mesh.rank}.pt"))
    res = run_mixup(_rows(setup["mixup"]["batch"]), setup["mixup"]["seeds"],
                    mesh)
    torch.save(res, os.path.join(out_dir, f"mixup.rank{mesh.rank}.pt"))


def runner(setup: dict, out_dir: str, mesh) -> None:
    from ofq_tpu_torch.cli import common
    from ofq_tpu_torch.cli import eval as cli_eval
    from ofq_tpu_torch.cli.runner import Runner
    from ofq_tpu_torch.train import checkpoint
    writes = []
    real_write = checkpoint._write

    def write(mgr, step, payload):
        writes.append((os.path.relpath(mgr.directory, setup["output"]),
                       step))
        real_write(mgr, step, payload)

    checkpoint._write = write
    out = {}
    for what, argv in (("fit", setup["fit"]), ("resume", setup["resume"])):
        r = Runner(common.parse_args(argv), device="cpu")
        best = r.fit()
        out[what] = dict(
            best=best, batch=r.data_cfg.batch_size,
            params={k: v.detach().clone()
                    for k, v in r.model.named_parameters()},
            buffers={k: v.clone() for k, v in r.model.named_buffers()})
    out["eval"] = cli_eval.main(setup["eval"], device="cpu")
    out["writes"] = writes
    torch.save(out, os.path.join(out_dir, f"runner.rank{mesh.rank}.pt"))


def main(mode: str, setup_path: str, out_dir: str) -> None:
    initialize_multihost(device="cpu")  # gloo, from the environment
    mesh = make_mesh(device="cpu")
    with open(setup_path, "rb") as f:
        setup = pickle.load(f)
    {"steps": steps, "runner": runner}[mode](setup, out_dir, mesh)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
