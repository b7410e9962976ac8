"""Data parallelism (`ofq_tpu_torch.parallel`) on the CPU: two ranks over
gloo, each a process of `torch_fixtures/parallel_worker.py` (which imports
no JAX), against the port's single-process step on the global batch and
against JAX's single-device `make_train_step` (which
`test_sharding.py::test_dp_matches_single_device` holds equal to JAX's
sharded step).

  * `param_spec` against `ofq_tpu.parallel.param_spec` on a DeiT tree,
    `make_mesh` (a 'model' axis that does not divide the world raises),
    `host_batch_slice`, and the refusal rule of `initialize_multihost`
    (`test_multihost.py`'s, with `init_process_group` made to fail), the
    backend by device;
  * one step each, the global batch of 4 split 2 + 2: the composed W2A2
    QKR student in fp64 (KD from a float teacher, AdamW at a mid-run
    state), its fused configuration (the plain versions), the BatchNorm
    student, the CGA step, the student with dropout, attention dropout
    and drop-path, and the `kd_qk` and `kd_qkv` steps (their Grams'
    norms over the global batch): every parameter leaf (and BatchNorm's running
    statistics) within 1e-10 relative L2 of the single-process step
    (summation order alone), the LSQ scale gradients by name within
    1e-5 (their sums are fp32 on both sides; the local batch's scale
    would be sqrt(2) off), and the composed, BatchNorm and CGA steps
    within the fp64 single-process tests' limits of JAX's step (the Gram
    losses' too); the dropout masks the single-process ones; the int8 step in fp32 under
    `test_torch_int8_slice.py`'s rule; the ranks' gradients, parameters,
    moments and buffers bit for bit;
  * mixup and cutmix at world 2: every rank's mixed images and soft
    labels are the single-process global batch's rows;
  * the Runner at world 2 (tiny DeiT, synthetic data): only rank 0
    writes, the ranks' parameters agree bit for bit, a resume continues
    at the next epoch; `cli.eval.main` at world 2 on an ImageFolder whose
    7 files leave a remainder (padding with label -1) gives the
    single-process top-1, top-5 and loss.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_batchnorm as tbn
import test_torch_cga_slice as tcga
from test_torch_dropout import x64_jit
from test_torch_port_common import to_jax_tree, to_numpy_tree
from test_torch_train_loop import (DEPTH, NAME, _flat, _jax_policy,
                                   _mid_run_adam, _student_variables,
                                   _teacher_variables)
from test_torch_train_slice import LR, START, _batches, _jax_state, _with_heads

from ofq_tpu import parallel as jparallel
from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch import parallel
from ofq_tpu_torch.cli import eval as cli_eval
from ofq_tpu_torch.parallel import multihost
from ofq_tpu_torch.quant import w2a2_deit_policy, w2a2_qkr_policy
from ofq_tpu_torch.train import cosine_with_warmup_cooldown

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
sys.path.insert(0, FIXTURES)
import parallel_worker as pw  # noqa: E402

WORLD = 2
# relative L2 per leaf against the single-process step: summation order
# alone.  A leaf whose gradient the path sums in fp64 moves by ~1e-16 of
# its gradient (SAME); one whose gradient is an fp32 sum (the LSQ scales
# and the shifts, whose `ds` and bias gradients the port sums in fp32, and
# in the fused configuration every leaf: the plain versions of K1-K3 form
# their products in fp32) moves by ~1e-7 of it, which AdamW's mid-run
# state turns into up to 9.1e-8 of the leaf (measured: `head.weight_quant.s`;
# every other such leaf <= 1.1e-8): FP32_SUMS.  The fused configuration's
# other leaves take their gradients through the plain versions' fp32
# products (measured <= 2.0e-10, `blocks_0.attn.proj.bias`): FUSED_PRODUCTS.
SAME = 1e-10
FP32_SUMS = 1e-6
FUSED_PRODUCTS = 1e-8
SCALE_GRAD = 1e-5   # the LSQ scale gradients, summed in fp32
COSINE = ("cosine", 5e-3, LR)
DROP = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
INT8 = dict(matmul_impl="int8", attn_impl=None)
FUSED = dict(matmul_impl="fused", attn_impl="fused")
GRAMS = dict(qqkkvv=True)


# ------------------------------------------------------------ the pieces
def test_param_spec_matches_jax():
    """Every leaf of a DeiT W2A2 QKR tree and of a float DeiT tree (qkv,
    fc1, proj, fc2, the QKR kernels and v bias)."""
    trees = [_student_variables(3)["params"], _teacher_variables(4)["params"]]
    seen = set()
    for tree in trees:
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, leaf in leaves:
            name = ".".join(p.key for p in path)
            want = tuple(jparallel.param_spec(path, leaf))
            got = parallel.param_spec(name, np.shape(leaf))
            assert got == want, (name, got, want)
            seen.add(got)
    assert {(), (None, "model"), ("model", None), ("model",)} <= seen


def test_make_mesh_and_host_batch_slice():
    """A process without a process group is a mesh of one; a 'model' axis
    that does not divide the world raises ValueError, and the BatchNorm
    student shards at model_parallel 2, its norms and running statistics
    whole (`test_torch_tensor_parallel.py` runs the 'model' axis)."""
    m = parallel.make_mesh(device="cpu")
    assert (m.world, m.rank, m.device.type, m.group) == (1, 0, "cpu", None)
    assert (m.model_parallel, m.data_world, m.data_index,
            m.model_index) == (1, 1, 0, 0)
    assert parallel.make_mesh(device="cuda").device == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.make_mesh(model_parallel=2, device="cpu")
    tp = parallel.Mesh(world=2, rank=1, local_rank=0,
                       device=torch.device("cpu"), model_parallel=2)
    assert (tp.data_world, tp.data_index, tp.model_index) == (1, 0, 1)
    bn = pw.create_model(NAME, policy=w2a2_deit_policy(2), device="cpu",
                         **tbn.BN)
    buffers = {n: b.clone() for n, b in bn.named_buffers()}
    layout = parallel.shard_model(bn, tp)
    assert "blocks_0.mlp.fc1.kernel" in layout.cuts
    assert not any(".norm" in n for n in layout.cuts)
    for n, b in bn.named_buffers():
        assert torch.equal(b, buffers[n]), n
    with pytest.raises(ValueError, match="n_devices"):
        parallel.make_mesh(n_devices=2, device="cpu")
    assert parallel.host_batch_slice(64) == (64, 0)
    assert parallel.host_batch_slice(64, tp) == (64, 0)
    assert parallel.backend_for("cuda:1") == "nccl"
    assert parallel.backend_for("cpu") == "gloo"


def test_failed_init_raises_on_declared_multiprocess(monkeypatch):
    """A failed `init_process_group` on a declared multi-process launch
    raises, never carries on as rank 0; the backend is the requested
    device's (or the explicit one) and is not switched on failure; a
    process with no launch declared does not try."""
    calls = []

    def boom(backend, **kw):
        calls.append(backend)
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(multihost.dist, "init_process_group", boom)
    monkeypatch.setattr(multihost.torch.cuda, "set_device", lambda i: None)
    for k in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    # explicit multi-process arguments
    with pytest.raises(RuntimeError, match="multi-process launch"):
        parallel.initialize_multihost("localhost:1", num_processes=2,
                                      process_id=0, device="cpu")
    assert calls == ["gloo"]
    # torchrun's environment: a world above 1, or a rendezvous address
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="multi-process launch"):
        parallel.initialize_multihost(backend="nccl", device="cpu")
    assert calls == ["gloo", "nccl"]
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="multi-process launch"):
        parallel.initialize_multihost(device="cpu")
    # one process, nothing declared: a no-op that does not try
    monkeypatch.delenv("MASTER_ADDR")
    parallel.initialize_multihost(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    parallel.initialize_multihost(device="cpu")
    parallel.initialize_multihost(num_processes=1, process_id=0,
                                  device="cpu")
    assert calls == ["gloo", "nccl", "gloo"]
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------ two ranks
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, setup, tmp):
    """Two ranks of the worker over gloo; their results by rank."""
    path = os.path.join(tmp, f"{mode}.pkl")
    with open(path, "wb") as f:
        pickle.dump(setup, f)
    port = str(_free_port())
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(FIXTURES, "parallel_worker.py"),
             mode, path, tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"


def _load(tmp, what):
    return [torch.load(os.path.join(tmp, f"{what}.rank{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def _case(variables, tvars, policy, *, conf=None, dtype="float64",
          lr=COSINE, **extra):
    mu, nu = _mid_run_adam(variables["params"], np.random.default_rng(5))
    npdt = np.float64 if dtype == "float64" else np.float32
    return dict(name=NAME, policy=policy, conf=conf or {}, dtype=dtype,
                variables=variables, tvars=tvars, mu=mu, nu=nu, lr=lr,
                start=START, batch=_batches(1, npdt)[0], **extra)


def _cases():
    qkr = _with_heads(_student_variables(3), np.random.default_rng(3))
    tvars = _teacher_variables(4)
    _, _, bn_vars, bn_tvars, _, _ = tbn.start(
        NAME, tbn.family(NAME)[1], w2a2_deit_policy(2), conf=tbn.BN)
    int8 = _with_heads(_student_variables(3, np.float32),
                       np.random.default_rng(3))
    pol = w2a2_qkr_policy(DEPTH)
    return {
        "qkr": _case(qkr, tvars, pol),
        "qkr_fused": _case(qkr, tvars, pol, conf=FUSED),
        "bn": _case(bn_vars, bn_tvars, w2a2_deit_policy(2), conf=tbn.BN),
        "cga": _case(qkr, tvars, tcga._port_policy(),
                     lr=("constant", tcga.LR, {}),
                     step_kw=dict(cga=tcga.CGA)),
        "dropout": _case(qkr, tvars, pol, conf=DROP, seed=7),
        "int8": _case(int8, tvars, pol, conf=INT8, dtype="float32"),
        # the Gram losses: their norms span the global batch
        **{kind: _case(qkr, tvars, pol, conf=GRAMS, teacher_conf=GRAMS,
                       step_kw=dict(loss_kind=kind))
           for kind in GRAM_LOSSES},
    }


MIX_SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The worker's results at world 2 and the port's single-process
    results on the global batch, by case."""
    tmp = str(tmp_path_factory.mktemp("dp_steps"))
    cases = _cases()
    rng = np.random.default_rng(9)
    mix = {"image": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
           "label": rng.integers(0, 10, size=4)}
    _launch("steps", dict(cases=cases, mixup=dict(batch=mix,
                                                  seeds=MIX_SEEDS)), tmp)
    out = {}
    for name, case in cases.items():
        single = pw.run_step(case, {k: torch.as_tensor(v) for k, v in
                                    case["batch"].items()})
        out[name] = dict(case=case, ranks=_load(tmp, name), single=single)
    out["mixup"] = dict(ranks=_load(tmp, "mixup"), single=pw.run_mixup(
        {k: torch.as_tensor(v) for k, v in mix.items()}, MIX_SEEDS))
    return out


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm()) / max(float(want.norm()), 1e-300)


GRAM_LOSSES = ("kd_qk", "kd_qkv")
FP64 = ("qkr", "qkr_fused", "bn", "cga", "dropout") + GRAM_LOSSES


def _limit(case, name):
    """A leaf's limit against the single-process step: FP32_SUMS for the
    LSQ scales and shifts, FUSED_PRODUCTS for the fused configuration's
    other leaves, SAME for the rest."""
    if name.endswith(".s") or ".move" in name or "_move" in name:
        return FP32_SUMS
    return FUSED_PRODUCTS if case == "qkr_fused" else SAME


@pytest.mark.parametrize("case", FP64)
def test_step_is_the_global_batch_step(steps, case):
    """Every leaf and running statistic after the world-2 step against
    the single-process step on the global batch (`_limit`)."""
    r = steps[case]
    single, dp = r["single"], r["ranks"][0]
    assert abs(dp["metrics"]["loss"] - single["metrics"]["loss"]) <= (
        1e-12 * abs(single["metrics"]["loss"]))
    assert set(dp["params"]) == set(single["params"])
    for k, w in single["params"].items():
        err = _rel_l2(dp["params"][k], w)
        assert err <= _limit(case, k), (k, err)
    assert any(_limit(case, k) < FP32_SUMS for k in single["params"])
    for k, w in single["buffers"].items():
        assert _rel_l2(dp["buffers"][k], w) <= SAME, k


@pytest.mark.parametrize("case", FP64 + ("int8",))
def test_lsq_scale_gradients_by_name(steps, case):
    """The all-reduced gradient of every LSQ scale (`*.s`), the image
    quantizer's among them, against the single-process one: a scale
    taken at the local batch's shape would be sqrt(2) off."""
    r = steps[case]
    single, dp = r["single"]["grads"], r["ranks"][0]["grads"]
    names = [k for k in single if k.endswith(".s")]
    assert "patch_embed.input_quant.s" in names and len(names) > 10
    for k in names:
        assert _rel_l2(dp[k], single[k]) <= SCALE_GRAD, k


@pytest.mark.parametrize("case", FP64 + ("int8",))
def test_ranks_agree_bit_for_bit(steps, case):
    a, b = steps[case]["ranks"]
    for key in ("grads", "params", "mu", "nu", "buffers"):
        assert set(a[key]) == set(b[key])
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)
    assert a["metrics"] == b["metrics"]


def test_dropout_masks_are_the_global_draw(steps):
    """Each rank's masks are its rows of the single-process masks, call
    for call (dropout, attention dropout, drop-path)."""
    r = steps["dropout"]
    single = r["single"]["masks"]
    shapes = {tuple(m.shape) for m in single}
    assert len(single) > 8 and (4, 1, 1) in shapes and any(
        len(s) == 4 for s in shapes)
    for rank, dp in enumerate(r["ranks"]):
        assert len(dp["masks"]) == len(single)
        for m, w in zip(dp["masks"], single):
            assert torch.equal(m, w[2 * rank:2 * rank + 2])


def test_int8_step_fp32(steps):
    """The int8 step in fp32 against the single-process one, under
    `test_torch_int8_slice.test_step_fp32`'s rule against JAX."""
    r = steps["int8"]
    single, dp = r["single"], r["ranks"][0]
    for k in ("loss", "grad_norm"):
        assert abs(dp["metrics"][k] - single["metrics"][k]) <= (
            1e-5 * abs(single["metrics"][k])), k
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    for k, w in single["params"].items():
        d = (dp["params"][k] - w).abs().numpy()
        assert d.max() <= 2.1 * lr, k
        assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w.numpy())) <= 0.01, k


def test_mixup_pairs_are_the_global_flip(steps):
    r = steps["mixup"]
    assert {m["cut"] for m in r["single"]} == {True, False}
    for i, want in enumerate(r["single"]):
        for key in ("image", "soft_label"):
            got = torch.cat([rk[i][key] for rk in r["ranks"]])
            assert torch.equal(got, want[key]), (i, key)


def _jax_step(case, jm, tx, jst, *, cga=None):
    kw = {"loss_kind": "kd_soft_hard", **case.get("step_kw", {})}
    kw.pop("cga", None)
    with x64_jit():
        jstep = jax.jit(jax_make_train_step(
            jm, tx, teacher=jax_deit_model(NAME,
                                           **case.get("teacher_conf", {})),
            cga=cga, **kw))
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in
                                case["batch"].items()},
                          jax.random.key(0),
                          to_jax_tree(case["tvars"], np.float64)["params"])
        return ({k: float(v) for k, v in jmet.items()},
                jax.tree.map(np.asarray, jst))


def _assert_leaves(params, want, *, scale_leaf=tbn.SCALE_LEAF):
    """Each leaf within 1e-9 of max(1, its largest magnitude) of JAX's,
    the LSQ scales within `test_torch_batchnorm`'s SCALE_LEAF (their
    gradients are fp32 sums in both frameworks, and at world 2 in two
    halves: the CGA step's head scale measured 1.09e-9)."""
    got = {k: v.numpy() for k, v in params.items()}
    want = _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max()) / max(1.0,
                                                    float(np.abs(w).max()))
        assert err <= (scale_leaf if k.endswith(".s") else 1e-9), (k, err)


def _assert_metrics(met, jmet):
    assert abs(met["loss"] - jmet["loss"]) <= 1e-9 * abs(jmet["loss"])
    assert abs(met["grad_norm"] - jmet["grad_norm"]) <= (
        1e-6 * jmet["grad_norm"])


def test_qkr_step_matches_jax(steps):
    """The composed W2A2 QKR step at world 2 against JAX's single-device
    step on the global batch (`test_torch_train_slice`'s first step)."""
    case, dp = steps["qkr"]["case"], steps["qkr"]["ranks"][0]
    with x64_jit():
        tx = jax_make_optimizer(
            jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
            weight_decay=0.05)
        jst = _jax_state(tx, case["variables"], case["mu"], case["nu"],
                         np.float64)
    jmet, jst = _jax_step(case, jax_deit_model(NAME, _jax_policy()), tx, jst)
    _assert_metrics(dp["metrics"], jmet)
    _assert_leaves(dp["params"], to_numpy_tree(jst.params["params"]))


@pytest.mark.parametrize("kind", GRAM_LOSSES)
def test_gram_step_matches_jax(steps, kind):
    """`kd_qk` and `kd_qkv` at world 2 (2 + 2 rows) against JAX's
    single-device step on the global batch of 4: the Grams' three squared
    sums of each layer summed over the ranks, the term's gradient weighed
    by the world; the loss to 1e-9 (the global loss), every leaf as
    `test_qkr_step_matches_jax`."""
    case, dp = steps[kind]["case"], steps[kind]["ranks"][0]
    with x64_jit():
        tx = jax_make_optimizer(
            jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
            weight_decay=0.05)
        jst = _jax_state(tx, case["variables"], case["mu"], case["nu"],
                         np.float64)
    jmet, jst = _jax_step(case, jax_deit_model(NAME, _jax_policy(),
                                               **GRAMS), tx, jst)
    _assert_metrics(dp["metrics"], jmet)
    _assert_leaves(dp["params"], to_numpy_tree(jst.params["params"]))


def test_bn_step_matches_jax(steps):
    """The BatchNorm student at world 2 against JAX's single-device step
    (`test_torch_batchnorm`'s limits: the LSQ scales 1e-8), the running
    statistics too."""
    case, dp = steps["bn"]["case"], steps["bn"]["ranks"][0]
    jm = jax_deit_model(NAME, tbn.family(NAME)[1], **tbn.BN)
    with x64_jit():
        tx = jax_make_optimizer(
            jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
            weight_decay=0.05)
        jst = _jax_state(tx, case["variables"], case["mu"], case["nu"],
                         np.float64)
    jmet, jst = _jax_step(case, jm, tx, jst)
    _assert_metrics(dp["metrics"], jmet)
    _assert_leaves(dp["params"], to_numpy_tree(jst.params["params"]))
    stats = _flat(to_numpy_tree(jst.params["batch_stats"]))
    assert stats
    for k, w in stats.items():
        err = float(np.abs(dp["buffers"][k].numpy() - w).max()) / max(
            1.0, float(np.abs(w).max()))
        assert err <= 1e-9, (k, err)


def test_cga_step_matches_jax(steps):
    """The CGA step at world 2 against JAX's (`test_torch_cga_slice`'s
    first step: parameters 1e-9, the moments 1e-12 of each leaf's largest
    entry but the fp32-summed LSQ scales and shifts, 1e-6)."""
    case, dp = steps["cga"]["case"], steps["cga"]["ranks"][0]
    with x64_jit():
        tx = jax_make_optimizer(jschedule.constant_lr(tcga.LR),
                                weight_decay=0.05)
        jst = tcga._jax_state(tx, case["variables"], case["mu"], case["nu"],
                              np.float64)
    jmet, jst = _jax_step(case, jax_deit_model(NAME, tcga._jax_policy()),
                          tx, jst, cga=tcga.CGA)
    _assert_metrics(dp["metrics"], jmet)
    _assert_leaves(dp["params"], to_numpy_tree(jst.params["params"]))
    adam = jst.opt_state[0][0]
    for got, want in ((dp["mu"], _flat(to_numpy_tree(adam.mu))),
                      (dp["nu"], _flat(to_numpy_tree(adam.nu)))):
        for k, w in want.items():
            fp32_sums = k.endswith(".s") or "move" in k
            e = tcga._rel_err(got[k].numpy(), w)
            assert e <= (1e-6 if fp32_sums else 1e-12), (k, e)


# ------------------------------------------------------------ the runner
MODEL = ["--model", "deit_test_distilled", "--img-size", "32",
         "--num-classes", "10", "--batch-size", "4", "--wq-enable",
         "--aq-enable", "--wq-bitw", "2", "--aq-bitw", "2",
         "--wq-per-channel", "--aq-per-channel", "--aq_clip_learnable",
         "--wq-mode", "statsq", "--quantized", "--qk_reparam",
         "--qk_reparam_type", "0", "--use-kd", "--teacher",
         "deit_test_distilled", "--teacher_type", "deit",
         "--kd_hard_and_soft", "1", "--seed", "0"]
FIT = ["synthetic", *MODEL, "--batch-size", "8", "--steps-per-epoch", "2",
       "--warmup-epochs", "0", "--cooldown-epochs", "0", "--mixup", "0.8",
       "--cutmix", "1.0", "--log-interval", "1", "--experiment", "dp"]
N_VAL = 7  # not a multiple of the world: one padding row of label -1


def _imagefolder(root):
    """`validation`: the fixtures' PNG and BMP and seeded PNGs, 2
    classes, N_VAL files."""
    rng = np.random.default_rng(0)
    src = [os.path.join(FIXTURES, "imagefolder", f)
           for f in ("plain.png", "plain.bmp")]
    for i in range(N_VAL):
        d = os.path.join(root, "validation", f"c{i % 2}")
        os.makedirs(d, exist_ok=True)
        if i < len(src):
            shutil.copy(src[i], os.path.join(d, f"{i}_{os.path.basename(src[i])}"))
        else:
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                            ).save(os.path.join(d, f"{i}.png"))
    return root


@pytest.fixture(scope="module")
def runner_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_runner"))
    out = os.path.join(tmp, "out")
    data = _imagefolder(os.path.join(tmp, "data"))
    ev = [data, *MODEL, "--output", os.path.join(tmp, "ev"), "--resume",
          os.path.join(out, "dp"), "--experiment", "ev"]
    setup = dict(output=out,
                 fit=FIT + ["--output", out, "--epochs", "1"],
                 resume=FIT + ["--output", out, "--epochs", "2"], eval=ev)
    _launch("runner", setup, tmp)
    single = cli_eval.main(ev[:-2] + ["--experiment", "ev1"], device="cpu")
    return dict(ranks=_load(tmp, "runner"), single=single, out=out)


def test_runner_rank0_writes_and_ranks_agree(runner_runs):
    r0, r1 = runner_runs["ranks"]
    assert r0["writes"] == [("dp", 0), ("dp", 1)] and r1["writes"] == []
    with open(os.path.join(runner_runs["out"], "dp", "summary.csv")) as f:
        rows = [line.split(",")[0] for line in f.read().splitlines()[1:]]
    assert rows == ["0", "1"]
    for what in ("fit", "resume"):
        assert r0[what]["batch"] == r1[what]["batch"] == 4
        for key in ("params", "buffers"):
            for k, v in r0[what][key].items():
                assert torch.equal(v, r1[what][key][k]), (what, key, k)
        assert r0[what]["best"] == r1[what]["best"]


def test_runner_resume_continues(runner_runs):
    r0 = runner_runs["ranks"][0]
    assert r0["fit"]["best"]["epoch"] == 0
    assert r0["resume"]["best"]["epoch"] == 1
    assert any(not torch.equal(v, r0["resume"]["params"][k])
               for k, v in r0["fit"]["params"].items())
    assert sorted(os.listdir(os.path.join(runner_runs["out"], "dp"))) == [
        "0", "1", "args.yaml", "summary.csv"]


def test_eval_world2_is_the_single_process_eval(runner_runs):
    single = runner_runs["single"]
    for got in (r["eval"] for r in runner_runs["ranks"]):
        assert (got["top1"], got["top5"]) == (single["top1"],
                                              single["top5"])
        # the mean cross-entropy: fp32 sums, in other orders
        assert abs(got["loss"] - single["loss"]) <= 1e-6 * abs(
            single["loss"])
