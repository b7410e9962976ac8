"""The port's runner on `swin_test` W2A2 QKR with `--replace-ln-by-bn`
(BatchNorm), mixup and drop-path, 1 epoch x 2 steps on the CPU, with no
JAX fit:

  * the runner adds nothing: its epoch-0 checkpoint equals, bit for bit
    (parameters, moments, BN running statistics, `signed`), two steps of
    `make_train_step` composed by hand from the same seeded model, the
    calibration batch, `synthetic_batches`, the learning rates of the
    schedule, mixup from a generator seeded `--seed + 1` and the step's
    generator seeded `--seed`.  That step is held against JAX's by
    `test_torch_swin_train.py` and `test_torch_batchnorm.py`;
  * the glue against the JAX runner's functions: `build_optimizer`'s
    learning rate at every step of both schedules (phase 1 and CGA's),
    `restore_experiment_params`' overlay, qkv split and BN-statistics
    overlay on the same trees (a non-QKR experiment saved by each
    package, restored into a QKR destination), bit for bit;
  * the BN statistics survive resume (restored bit for bit) and
    evaluation (`evaluate_only` from the experiment: the same buffers and
    the same counts and loss as the trained model's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_common import to_numpy_tree

from ofq_tpu.cli import common as jcommon
from ofq_tpu.cli import runner as jrunner
from ofq_tpu.train import TrainState as JaxTrainState
from ofq_tpu.train import checkpoint as jckpt
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.cli import common, runner
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.data import mixup_cutmix, synthetic_batches
from ofq_tpu_torch.data.pipeline import DataConfig
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.train import (TrainState, cosine_with_warmup_cooldown,
                                 make_eval_step, make_optimizer,
                                 make_train_step)
from ofq_tpu_torch.train import checkpoint as ckpt

SEED = 3
BASE = ["synthetic", "--model", "swin_test", "--model_type", "swin",
        "--img-size", "32", "--num-classes", "10", "--batch-size", "4",
        "--steps-per-epoch", "2", "--epochs", "1", "--warmup-epochs", "1",
        "--warmup-lr", "1e-4", "--lr", "2e-3", "--cooldown-epochs", "0",
        "--wq-enable", "--aq-enable", "--wq-bitw", "2", "--aq-bitw", "2",
        "--wq-per-channel", "--aq-per-channel", "--aq_clip_learnable",
        "--quantized", "--qk_reparam", "--replace-ln-by-bn",
        "--drop-path", "0.1", "--seed", str(SEED), "--log-interval", "1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("swin"))
    argv = BASE + ["--output", out, "--experiment", "p1"]
    r = runner.Runner(common.parse_args(argv), device="cpu")
    r.fit()
    return dict(out=out, argv=argv, runner=r,
                exp=os.path.join(out, "p1"))


def _composed(args):
    """Two steps composed by hand, as the runner's loop should take
    them: (model, state)."""
    pol = common.policy_from_namespace(args)
    model = create_model("swin_test", policy=pol, device="cpu",
                         generator=torch.Generator().manual_seed(SEED),
                         num_classes=10, qqkkvv=False, drop_path_rate=0.1,
                         norm_layer="batchnorm")
    cfg = DataConfig(img_size=32, batch_size=4, num_classes=10, seed=SEED,
                     synthetic_length=8)
    stream = synthetic_batches(cfg, train=True)
    first = next(synthetic_batches(cfg, train=True))
    calibrate(model, first["image"])
    lr_epoch = cosine_with_warmup_cooldown(2e-3, epochs=1, warmup_epochs=1,
                                           warmup_lr=1e-4, min_lr=1e-5)
    opt = make_optimizer(lambda c: lr_epoch(c // 2), weight_decay=0.05)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_kind="ce", label_smoothing=0.1,
                           device="cpu", master_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    mix = torch.Generator().manual_seed(SEED + 1)
    for _ in range(2):
        b = next(stream)
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        batch = mixup_cutmix(batch, mix, num_classes=10,
                             label_smoothing=0.1)
        batch["label"] = batch.pop("soft_label")
        state, _ = step(state, batch, gen)
    return model, state


def test_runner_equals_composed_steps(run):
    model, state = _composed(common.parse_args(run["argv"]))
    payload = ckpt.load(ckpt.make_manager(run["exp"]), 0)
    assert payload["step"] == 2 and payload["opt_state"]["count"] == 2
    for what, got, want in (
            ("params", payload["params"], dict(model.named_parameters())),
            ("mu", payload["opt_state"]["mu"], state.opt_state.mu),
            ("nu", payload["opt_state"]["nu"], state.opt_state.nu),
            ("buffers", payload["buffers"], dict(model.named_buffers()))):
        assert sorted(got) == sorted(want), what
        for k, w in want.items():
            assert torch.equal(got[k], w.detach()), (what, k)
    bn = [k for k in payload["buffers"] if k.endswith((".mean", ".var"))]
    assert bn and any(
        not torch.equal(payload["buffers"][k], torch.zeros_like(
            payload["buffers"][k])) for k in bn if k.endswith(".mean"))


@pytest.mark.parametrize("cga_mode", [False, True], ids=["phase1", "cga"])
def test_build_optimizer_learning_rates(cga_mode):
    argv = BASE + ["--epochs", "6", "--warmup-epochs", "2",
                   "--cooldown-epochs", "1", "--min-lr", "3e-5"]
    spe = 3
    r = runner.Runner(common.parse_args(argv), cga_mode=cga_mode,
                      device="cpu")
    jr = jrunner.Runner(jcommon.parse_args(argv), cga_mode=cga_mode)
    opt, lr_epoch = r.build_optimizer(spe)
    _, jlr_epoch = jr.build_optimizer(spe)
    for count in range(7 * spe + 2):
        want = np.float32(jlr_epoch(count // spe))
        assert opt.lr_schedule(count) == float(want), count
        assert lr_epoch(count // spe) == float(want), count


def _saved_values(args_list):
    """Perturbed Flax variables of the non-QKR swin_test BN student."""
    jargs = jcommon.parse_args(args_list)
    jm = jrunner.build_model(jargs, jcommon.policy_from_namespace(jargs))
    v = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(7), jnp.asarray(np.random.default_rng(7).normal(
            size=(2, 32, 32, 3)), jnp.float32))
    v = to_numpy_tree(v, np.float32)
    rng = np.random.default_rng(8)
    return jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.1
                                   ).astype(np.float32), v)


def _save_experiment(exp_dir, args_list, v, jax_side):
    """An experiment with one checkpoint holding `v`, saved by the JAX
    package (orbax) or by the port (torch.save)."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "args.yaml"), "w") as f:
        yaml.safe_dump(vars(jcommon.parse_args(args_list)), f)
    if jax_side:
        tx = jax_make_optimizer(lambda _: 0.0, weight_decay=0.05)
        st = JaxTrainState.create(jax.tree.map(jnp.asarray, v), tx)
        mgr = jckpt.make_manager(exp_dir)
        jckpt.save_epoch(mgr, 0, st, {"top1": 1.0})
        mgr.wait_until_finished()
        mgr.close()
    else:
        args = common.parse_args(args_list)
        m = runner.build_model(args, common.policy_from_namespace(args),
                               device="cpu")
        load_flax_params(m, v)
        st = TrainState.create(m, make_optimizer(lambda c: 0.0))
        ckpt.save_epoch(ckpt.make_manager(exp_dir), 0, st, {"top1": 1.0},
                        buffers=dict(m.named_buffers()))


def test_restore_experiment_params_matches_jax(tmp_path):
    saved = [a for a in BASE if a != "--qk_reparam"]
    v = _saved_values(saved)
    _save_experiment(str(tmp_path / "jax"), saved, v, True)
    _save_experiment(str(tmp_path / "port"), saved, v, False)
    args, jargs = common.parse_args(BASE), jcommon.parse_args(BASE)
    r = runner.Runner(args, device="cpu")
    jr = jrunner.Runner(jargs)
    dest = to_numpy_tree(jax.jit(
        lambda k, x: jr.model.init({"params": k}, x, train=False))(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3))), np.float32)
    want, jloaded = jr.restore_experiment_params(
        str(tmp_path / "jax"), jax.tree.map(jnp.asarray, dest),
        return_loaded=True)
    got, loaded = r.restore_experiment_params(str(tmp_path / "port"), dest,
                                              return_loaded=True)
    assert "q_kernel" in loaded["features_1_0"]["attn"]  # split
    for a, b in ((got, to_numpy_tree(want)), (loaded, to_numpy_tree(
            jloaded))):
        fa, fb = flatten_flax_tree(a), flatten_flax_tree(b)
        assert sorted(fa) == sorted(fb)
        for k in fb:
            np.testing.assert_array_equal(
                np.asarray(fa[k], np.float32), np.asarray(fb[k], np.float32),
                err_msg=k)
    bs = flatten_flax_tree(got["batch_stats"])
    np.testing.assert_array_equal(
        bs["features_1_0/norm1/mean"],
        v["batch_stats"]["features_1_0"]["norm1"]["mean"])


def test_batch_stats_survive_resume_and_eval(run):
    payload = ckpt.load(ckpt.make_manager(run["exp"]), 0)
    buffers = payload["buffers"]
    trained = run["runner"]
    metrics = trained.evaluate(make_eval_step(trained.model), None)
    # eval from the experiment directory
    ev = runner.Runner(common.parse_args(
        run["argv"] + ["--resume", run["exp"]]), device="cpu")
    got = ev.evaluate_only()
    for k, t in ev.model.named_buffers():
        assert torch.equal(t, buffers[k]), k
    assert got == metrics
    # resume: a fresh runner restores the statistics into its model
    r = runner.Runner(common.parse_args(run["argv"]), device="cpu")
    state = TrainState.create(r.model, make_optimizer(lambda c: 0.0))
    _, nxt = ckpt.restore_latest(ckpt.make_manager(run["exp"]), state,
                                 r.model)
    assert nxt == 1
    for k, t in r.model.named_buffers():
        assert torch.equal(t, buffers[k]), k
