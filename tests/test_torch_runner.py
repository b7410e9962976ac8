"""The port's runner and CLI against the JAX package's `Runner`, on one
argv: `deit_test_distilled` W2A2 QKR at 32 px, B=8, 2 epochs x 2 steps,
synthetic data, fp32, KD (`--kd_hard_and_soft 1`) from a float teacher,
no mixup, dropout or drop-path (nothing drawn at random after the
start, so both runs follow one trajectory).

Both runs start from one pickle of JAX's calibrated student variables
(every scale present, shifts and heads moved off their init) through
`--initial-checkpoint`, and from one teacher `.pth.tar` through
`--teacher_checkpoint`.  The JAX runner converts a teacher file with
`convert_deit`'s default depth of 12, so the file holds 12 blocks of the
test model's width; both runners take blocks 0 and 1 from it.  JAX runs
`Runner.fit` once for phase 1 and once for one CGA step (the module
fixture; JAX's SIGTERM handler, which its `fit` leaves installed, is put
back after each); the port runs `cli.train.main` and `cli.cga.main` with
`device="cpu"`.

  * `summary.csv`: the same epochs; top-1 and top-5 equal (the eval
    counts), the train and eval losses within 1e-4 relative;
  * the final parameters, the fp32 trajectory rule of
    `test_torch_train_slice_fused.py` over the run's 4 steps: AdamW's
    first step is ~ lr * sign(g), so an entry whose gradient is fp32
    noise may step the other way; every entry lies within 2.1 x the
    summed learning rates, and at most 1 % of a leaf's entries differ by
    more than 1e-3 x the summed rates + 1e-6 |p|, but for QKR's shifts
    around the qkx quantization (`move_qkx_b4`, `move_qkx_aft`): their
    gradients sum the C x C x N qkx contraction through 2-bit roundings
    in other fp32 orders, so after the first (sign) step their updates
    differ in most entries; each lies within 0.1 x the summed rates
    (measured: 0.052).  Every other leaf agrees to better than 1e-3 of
    the summed rates in every entry on this case;
  * the CGA step: each runner freezes exactly its own `freeze_masks` of
    its phase-1 best weights (those entries keep their bits, every other
    CGA entry moves), and the two masks are equal but where an image lies
    within the two runs' difference in that image plus 2 fp32 ulps of a
    band edge (the allowance of `test_torch_cga.py`);
  * port only: auto-resume to epoch 2, `recalibrate_missing_scales` with
    two scales pruned against JAX's on the same tree (fp64, rtol 1e-7), the
    SIGTERM handler restored after `fit` returns and after it raises.
"""

import csv
import functools
import os
import pickle
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import to_jax_tree, to_numpy_tree, x64

from ofq_tpu.cli import common as jcommon
from ofq_tpu.cli import runner as jrunner
from ofq_tpu.convert import torch_export as jexport
from ofq_tpu.data import pipeline as jpipeline
from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.train import checkpoint as jckpt
from ofq_tpu.train import cga as jcga
from ofq_tpu_torch.cli import cga as port_cga
from ofq_tpu_torch.cli import common, runner
from ofq_tpu_torch.cli import train as port_train
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.train import checkpoint as ckpt
from ofq_tpu_torch.train import freeze_masks, is_cga_kernel

BASE = ["synthetic", "--model", "deit_test_distilled", "--img-size", "32",
        "--num-classes", "10",
        "--batch-size", "8", "--steps-per-epoch", "2", "--epochs", "2",
        "--warmup-epochs", "0", "--cooldown-epochs", "0", "--mixup", "0",
        "--cutmix", "0", "--wq-enable", "--aq-enable", "--wq-bitw", "2",
        "--aq-bitw", "2", "--wq-per-channel", "--aq-per-channel",
        "--aq_clip_learnable", "--wq-mode", "statsq", "--quantized",
        "--qk_reparam", "--qk_reparam_type", "0", "--use-kd", "--teacher",
        "deit_test_distilled", "--teacher_type", "deit",
        "--kd_hard_and_soft", "1", "--teacher_pretrained",
        "--log-interval", "1", "--seed", "0"]
CGA = ["--qk_reparam_type", "1", "--boundaryRange", "0.005",
       "--freeze_for_n_epochs", "1", "--steps-per-epoch", "1"]
LR_SUM = 2 * 5e-4 + 2 * 2.5500e-4  # the cosine rates of epochs 0 and 1
# QKR's shifts around the qkx quantization: their gradients sum the
# C x C x N qkx contraction through 2-bit roundings, in other fp32 orders
QKX_SHIFTS = ("move_qkx_b4", "move_qkx_aft")
BR = 0.005


def _student_pickle(path):
    """JAX's calibrated variables (the JAX runner's `calibrate_init` on the
    calibration batch), shifts and heads moved off their init."""
    args = jcommon.parse_args(BASE)
    jr = jrunner.Runner(args)
    first = next(jpipeline.synthetic_batches(
        jpipeline.DataConfig(img_size=32, batch_size=8, seed=0,
                             synthetic_length=16), train=True))
    variables = to_numpy_tree(jr.calibrate_init(first), np.float32)
    params = variables["params"]
    rng = np.random.default_rng(3)
    for path_, leaf in flatten_flax_tree(params).items():
        *keys, name = path_.split("/")
        node = params
        for k in keys:
            node = node[k]
        if name == "bias" or (keys[:1] in (["head"], ["head_dist"])
                              and name == "kernel"):
            node[name] = (leaf + rng.normal(size=leaf.shape) * 0.2
                          ).astype(np.float32)
    with open(path, "wb") as f:
        pickle.dump(params, f)
    return variables


def _teacher_file(path):
    """A 12-block float teacher of the test model's width, `.pth.tar`."""
    m = jax_deit_model("deit_test_distilled", depth=12, num_classes=10)
    v = jax.jit(lambda k, x: m.init({"params": k}, x, train=False))(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(
        lambda a: np.asarray(a) + np.random.default_rng(4).normal(
            size=a.shape).astype(np.float32) * 0.05, to_numpy_tree(
                v["params"], np.float32))
    jexport.save_pth_tar(jexport.export_deit(params), path)


def _jax_fit(argv, cga_mode):
    previous = signal.getsignal(signal.SIGTERM)
    try:
        return jrunner.Runner(jcommon.parse_args(argv),
                              cga_mode=cga_mode).fit()
    finally:
        signal.signal(signal.SIGTERM, previous)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    student = str(d / "student.pkl")
    teacher = str(d / "teacher.pth.tar")
    variables = _student_pickle(student)
    _teacher_file(teacher)
    out = str(d / "out")
    files = ["--initial-checkpoint", student, "--teacher_checkpoint",
             teacher, "--output", out]
    _jax_fit(BASE + files + ["--experiment", "jax"], False)
    _jax_fit(BASE + CGA + ["--teacher_checkpoint", teacher, "--output", out,
                           "--experiment", "jax_cga", "--initial-checkpoint",
                           os.path.join(out, "jax")], True)

    def sentinel(signum, frame):
        pass

    previous = signal.signal(signal.SIGTERM, sentinel)
    try:
        port_best = port_train.main(BASE + files + ["--experiment", "port"],
                                    device="cpu")
        after_fit = signal.getsignal(signal.SIGTERM)
        port_cga.main(BASE + CGA + [
            "--teacher_checkpoint", teacher, "--output", out,
            "--experiment", "port_cga", "--resume",
            os.path.join(out, "port")], device="cpu")
    finally:
        signal.signal(signal.SIGTERM, previous)
    return dict(dir=d, out=out, student=student, teacher=teacher,
                pickled=variables["params"], variables=variables,
                port_best=port_best,
                handler_restored=after_fit is sentinel)


def _summary(path):
    with open(os.path.join(path, "summary.csv")) as f:
        return list(csv.DictReader(f))


@functools.lru_cache(maxsize=None)
def _jax_params(exp_dir, use_best):
    """The params of a JAX experiment's best (or latest) orbax checkpoint,
    restored into the structure the JAX runner saves (traced, not
    compiled)."""
    jr = jrunner.Runner(jcommon.parse_args(BASE))
    shapes = jax.eval_shape(lambda k: jr.model.init(
        {"params": k}, jnp.zeros((1, 32, 32, 3)), train=False),
        jax.random.key(0))
    mgr = jckpt.make_manager(exp_dir)
    abstract = jr.abstract_state(shapes)
    state = (jckpt.restore_best(mgr, abstract) if use_best
             else jckpt.restore_latest(mgr, abstract)[0])
    mgr.close()
    return {k.replace("/", "."): v for k, v in flatten_flax_tree(
        to_numpy_tree(state.params["params"], np.float32)).items()}


def _port_params(exp_dir, best):
    mgr = ckpt.make_manager(exp_dir)
    payload = ckpt.load(mgr, mgr.best_step() if best else mgr.latest_step())
    return {k: v.float().numpy() for k, v in payload["params"].items()}


def test_summary_epochs_and_eval_counts(runs):
    out = runs["out"]
    jax_rows, port_rows = (_summary(os.path.join(out, e))
                           for e in ("jax", "port"))
    assert [r["epoch"] for r in port_rows] == [r["epoch"] for r in
                                               jax_rows] == ["0", "1"]
    for p, j in zip(port_rows, jax_rows):
        assert (p["top1"], p["top5"]) == (j["top1"], j["top5"])
        for k in ("train_loss", "lr"):
            assert abs(float(p[k]) - float(j[k])) <= 1e-4 * abs(float(j[k]))
    top1 = [float(r["top1"]) for r in jax_rows]
    assert runs["port_best"]["epoch"] == top1.index(max(top1))
    cga = (_summary(os.path.join(out, e)) for e in ("jax_cga", "port_cga"))
    j, p = next(cga), next(cga)
    assert [r["epoch"] for r in p] == [r["epoch"] for r in j] == ["0"]
    assert (p[0]["top1"], p[0]["top5"]) == (j[0]["top1"], j[0]["top5"])
    assert float(p[0]["lr"]) == float(j[0]["lr"]) == np.float32(1e-5)


def test_final_params_follow_jax(runs):
    want = _jax_params(os.path.join(runs["out"], "jax"), use_best=False)
    got = _port_params(os.path.join(runs["out"], "port"), best=False)
    assert sorted(got) == sorted(want)
    moved = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2.1 * LR_SUM, (k, d.max())
        if any(part in QKX_SHIFTS for part in k.split(".")):
            assert d.max() <= 0.1 * LR_SUM, (k, d.max())
        else:
            assert np.mean(d > 1e-3 * LR_SUM + 1e-6 * np.abs(w)) <= 0.01, k
        start = flatten_flax_tree(runs["pickled"]).get(k.replace(".", "/"))
        if start is not None:
            moved += int(np.any(got[k] != start))
    assert moved > len(want) // 2  # the run trained


def _b4(w):
    """The >= fp32 pre-round StatsQ images of a kernel, per column (the
    reduction CGA's masks read)."""
    w = np.asarray(w, np.float32)
    s = 2.0 * np.mean(np.abs(w), axis=0, keepdims=True, dtype=np.float32)
    return np.clip(w / s, -1, 1 - 1e-6) * 2.0 - 0.5


def test_cga_step_freezes_the_same_entries(runs):
    out = runs["out"]
    j0 = _jax_params(os.path.join(out, "jax"), use_best=True)
    j1 = _jax_params(os.path.join(out, "jax_cga"), use_best=False)
    p0 = _port_params(os.path.join(out, "port"), best=True)
    p1 = _port_params(os.path.join(out, "port_cga"), best=False)
    pmask = freeze_masks({k: torch.from_numpy(v) for k, v in p0.items()},
                         bits=2, boundary_range=BR, qk_reparam=True)
    kernels = [k for k in p0 if is_cga_kernel(k, qk_reparam=True,
                                              model_type="deit")]
    assert kernels
    frozen = differ = 0
    for k in kernels:
        pm = pmask[k].numpy() > 0.5
        jm = np.asarray(jcga.outer_freeze_mask(jnp.asarray(j0[k]), 2,
                                               BR)) > 0.5
        for name, m, a, b in (("port", pm, p0[k], p1[k]),
                              ("jax", jm, j0[k], j1[k])):
            np.testing.assert_array_equal(a[m], b[m], err_msg=(name, k))
            assert np.all(a[~m] != b[~m]), (name, k)
        frozen += int(pm.sum())
        # an image is an edge case where the two runs' images straddle a
        # band edge: its distance to the nearest edge is within their
        # difference plus 2 ulps
        bj, bp = _b4(j0[k]), _b4(p0[k])
        lvl = np.round(bj)
        edge = np.minimum(np.abs(np.abs(bj - lvl) - (0.5 - BR)),
                          np.abs(np.abs(bj - lvl) - 0.5))
        near = edge <= np.abs(bp - bj) + 2 * np.spacing(
            np.abs(bj).astype(np.float32) + 1)
        assert np.all(near[pm != jm]), k
        differ += int((pm != jm).sum())
    print(f"frozen entries {frozen}, masks differing at band edges "
          f"{differ}")
    assert frozen > 0


def test_auto_resume_to_epoch_2(runs):
    """Phase 1 again with `--epochs 3` in a copy of the experiment: it
    continues at epoch 2 from the restored state; summary 0, 1, 2."""
    out = str(runs["dir"] / "resume")
    shutil.copytree(os.path.join(runs["out"], "port"),
                    os.path.join(out, "port"))
    before = _port_params(os.path.join(out, "port"), best=False)
    argv = BASE + ["--initial-checkpoint", runs["student"],
                   "--teacher_checkpoint", runs["teacher"], "--output", out,
                   "--experiment", "port", "--epochs", "3"]
    args = common.parse_args(argv)
    r = runner.Runner(args, device="cpu")
    seen = {}
    real = ckpt.restore_latest

    def spy(mgr, state, model=None):
        st, nxt = real(mgr, state, model)
        seen["next"] = nxt
        seen["params"] = {k: v.detach().clone().numpy()
                          for k, v in state.params.items()}
        seen["step"] = state.step
        return st, nxt

    runner.restore_latest = spy
    try:
        r.fit()
    finally:
        runner.restore_latest = real
    assert seen["next"] == 2 and seen["step"] == 4
    for k, v in before.items():
        np.testing.assert_array_equal(seen["params"][k], v, err_msg=k)
    assert [row["epoch"] for row in _summary(os.path.join(out, "port"))] == [
        "0", "1", "2"]
    mgr = ckpt.make_manager(os.path.join(out, "port"))
    assert ckpt.load(mgr, mgr.latest_step())["step"] == 6


def test_recalibrate_missing_scales_matches_jax(runs):
    """Two scales pruned from the loaded tree (an activation scale in
    block 0 and one downstream in block 1): both runners' functions
    redo those two from the loaded weights and keep every other, in fp64
    (x64 on the JAX side; in fp32 a rounding of a 2-bit activation that
    flips between the two forwards moves a downstream scale's mean by a
    whole step over the batch)."""
    args = common.parse_args(BASE)
    jargs = jcommon.parse_args(BASE)
    jm = jrunner.build_model(jargs, jcommon.policy_from_namespace(jargs))
    x = np.random.default_rng(5).normal(size=(8, 32, 32, 3)).astype(
        np.float32)
    jvars = to_numpy_tree(runs["variables"], np.float64)
    pruned = ("blocks_0/attn/quant_x/s", "blocks_1/mlp/fc2/input_quant/s")
    loaded = jax.tree.map(np.copy, jvars["params"])
    for path in pruned:
        *keys, leaf = path.split("/")
        node = loaded
        for k in keys:
            node = node[k]
        del node[leaf]
    with x64():
        want, n = jrunner.recalibrate_missing_scales(
            jm, to_jax_tree(jvars, np.float64), loaded,
            jnp.asarray(x, jnp.float64))
    assert n == 2
    pol = common.policy_from_namespace(args)
    port = runner.build_model(args, pol, device="cpu").double()
    load_flax_params(port, jvars)
    got, pn = runner.recalibrate_missing_scales(port, jvars, loaded,
                                                x.astype(np.float64))
    assert pn == 2
    g = flatten_flax_tree(got["params"])
    w = flatten_flax_tree(to_numpy_tree(want["params"], np.float64))
    before = flatten_flax_tree(jvars["params"])
    for k in w:
        if k in pruned:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-7, err_msg=k)
            assert not np.array_equal(w[k], before[k]), k
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    named = dict(port.named_parameters())
    for k in pruned:
        np.testing.assert_array_equal(
            named[k.replace("/", ".")].detach().numpy(), g[k])


def test_sigterm_handler_restored(runs, monkeypatch):
    """`fit` puts the previous handler back when it returns (the fixture's
    run) and when it raises."""
    assert runs["handler_restored"]
    args = common.parse_args(["synthetic", "--model", "deit_test_distilled",
                              "--img-size", "32", "--output",
                              str(runs["dir"] / "raise")])
    r = runner.Runner(args, device="cpu")
    inside = {}

    def boom():
        inside["handler"] = signal.getsignal(signal.SIGTERM)
        raise RuntimeError("stop")

    monkeypatch.setattr(r, "_fit", boom)

    def mine(signum, frame):
        pass

    previous = signal.signal(signal.SIGTERM, mine)
    try:
        with pytest.raises(RuntimeError, match="stop"):
            r.fit()
        assert signal.getsignal(signal.SIGTERM) is mine
        assert inside["handler"] is not mine
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_one_process_refusals(monkeypatch):
    args = common.parse_args(["synthetic", "--mesh-model-parallel", "2"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        runner.Runner(args, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        runner.Runner(common.parse_args(["synthetic"]), device="cpu")


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.Runner(common.parse_args(["synthetic", "--model",
                                         "deit_test_distilled"]))


def test_bn_warm_start_follows_jax(tmp_path):
    """The warm start keeps the JAX runner's two departures from the
    original repository (`ofq_tpu/cli/runner.py:375-388`): a
    `--replace-ln-by-bn` student inherits a LayerNorm checkpoint's
    affines as its BatchNorms' scale and bias, and a pickle warm start
    carries no running statistics (they stay at mean 0, var 1)."""
    from ofq_tpu_torch.convert import model_variables, torch_export
    from ofq_tpu_torch.models import create_model
    from ofq_tpu_torch.quant import QuantPolicy

    fp = create_model("deit_test_distilled", policy=QuantPolicy(),
                      device="cpu", num_classes=10,
                      generator=torch.Generator().manual_seed(5))
    params = model_variables(fp)["params"]
    params["blocks_0"]["norm1"]["scale"] = params["blocks_0"]["norm1"][
        "scale"] * 0 + 1.5
    pth = torch_export.save_pth_tar(torch_export.export_deit(params),
                                    str(tmp_path / "ln.pth.tar"))
    pkl = str(tmp_path / "p.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(params, f)
    for path in (pth, pkl):
        args = common.parse_args(BASE + ["--replace-ln-by-bn",
                                          "--initial-checkpoint", path])
        r = runner.Runner(args, device="cpu")
        first = next(jpipeline.synthetic_batches(
            jpipeline.DataConfig(img_size=32, batch_size=8, seed=0,
                                 synthetic_length=16), train=True))
        r.load_pretrained(r.calibrate_init(first), calib_batch=first)
        norm1 = r.model.blocks_0.norm1
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(
                getattr(norm1, leaf).detach().numpy(),
                params["blocks_0"]["norm1"][leaf])
        assert torch.equal(norm1.mean, torch.zeros_like(norm1.mean))
        assert torch.equal(norm1.var, torch.ones_like(norm1.var))
