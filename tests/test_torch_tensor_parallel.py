"""Tensor parallelism (`ofq_tpu_torch.parallel`'s 'model' axis) on the CPU:
the small DeiT W2A2 QKR student (depth 2, embed 32, 4 heads, image 32,
patch 8, distilled, 10 classes) at world 2 (one model group of 2) and at
world 4 (2 data x 2 model), over gloo, in fp64, each rank a process of
`torch_fixtures/tp_worker.py` (which imports no JAX); this process
computes the port's single-process results and JAX's.

  * the layout: JAX's rank -> (data, model) map; shard then gather is the
    identity for every parameter (`quan_qkx.s`'s strided slice too); the
    group's StatsQ scale from the shards is `statsq_scale` of the whole
    kernel bit for bit; a row-parallel K1 on its codes' units is K1's
    plain version bit for bit;
  * calibration before sharding is the single process's bit for bit, the
    sharded eval forward's logits are the single process's and JAX's;
  * one KD step each of the composed, fused (the plain versions of K1-K3)
    and pallas (K4's plain version) configurations, with dropout, and of
    CGA: every parameter, gradient and moment against the single process
    on the global batch (`test_torch_parallel`'s limits: the model
    group's partial sums add in another order), and the composed,
    fused, pallas and CGA steps against JAX's single-device jitted step
    under x64 (1e-9 of each leaf's magnitude after one step, the
    fp64 trajectories' limit; the fp32-summed LSQ scales to their own);
    the pallas and fused steps in the bf16 stream against the single
    process under `test_torch_pallas_slice`'s bf16 rule; the dropout masks
    the global draw, cut;
    CGA's masks the single process's and JAX's;
  * the replicated gradients bit-equal across the model ranks;
  * checkpoints: the file of a sharded state holds the single process's
    names, shapes and dtypes and restores at mp 1; a single process's
    file restores into the shards, and a rank's own file back into it;
  * the Runner at world 2 with `--mesh-model-parallel 2`: 2 steps on
    synthetic data, rank 0 writes, `cli.eval.main` on the checkpoint at
    mp 2 equals the single-process eval;
  * the refusals of the configurations not ported at mp > 1, each naming
    its ROADMAP item.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_batchnorm as tbn
import test_torch_cga_slice as tcga
from test_torch_dropout import x64_jit
from test_torch_parallel import SAME, _free_port, _rel_l2
from test_torch_train_loop import _flat
from test_torch_train_slice import LR, START, _jax_state

from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.ops import pallas_statsq as jps
from ofq_tpu.quant import default_deit_qmodules, policy_from_args
from ofq_tpu.train import cga as jcga
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch import parallel
from ofq_tpu_torch.cli import common
from ofq_tpu_torch.cli import eval as cli_eval
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.models import deit as deit_models
from ofq_tpu_torch.parallel import Mesh, tensor
from ofq_tpu_torch.quant import (QuantPolicy, statsq_scale, w2a2_deit_policy,
                                 w2a2_qkr_policy)
from ofq_tpu_torch.serve import Predictor
from ofq_tpu_torch.train import (TrainState, checkpoint, make_optimizer,
                                 make_train_step)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_fixtures")
sys.path.insert(0, FIXTURES)
import tp_worker as tw  # noqa: E402

MP = 2
B = 8                         # the global batch: 4 rows per data index at 2
DEPTH = 2
LAUNCH_TIMEOUT = 300          # s, one launch of the ranks
# the limits against the single process: `test_torch_parallel`'s (the
# model group sums partial products and `ds` in another order): SAME for
# a leaf whose gradient is an fp64 sum, FP32_SUMS for the LSQ scales and
# shifts (their gradients are fp32 sums) and, in the fused and pallas
# configurations, every leaf (the plain versions' products are fp32):
# measured 2.3e-8 (fused, `quant_x_move_aft.bias`).
FP32_SUMS = 1e-6
SCALE_GRAD = 1e-5
# against JAX after one step in fp64: 1e-9 of max(1, |leaf|) (the
# fp64 trajectories' limit, ROADMAP Queue 3 item 4); the LSQ scales and
# shifts, whose gradients both sum in fp32, `test_torch_batchnorm`'s
# SCALE_LEAF (measured 1.4e-9, `move_qkx_aft.bias`); fused and pallas
# round their products to fp32 where JAX's composition (fused) does not:
# FP32_PRODUCTS.
JAX_LEAF = 1e-9
FP32_PRODUCTS = 1e-7
# gradients against JAX (read off the moments, g = (mu' - b1 mu) / (1 -
# b1)): 1e-9 of the step's largest gradient entry, the LSQ scales' (fp32
# sums) relative L2 SCALE_GRAD, the shifts' (fp32 sums, `bias_add`)
# FP32_SUM_GRADS of the largest entry (2^-24 of their terms; measured
# 2.1e-9, `move_qkx_aft.bias`, whose gradient cancels to noise: the
# softmax is blind to a per-head shift of qkx); with fp32 products
# FP32_PRODUCT_GRADS (measured 2.2e-7, `cls_token`) and the scales' 1e-3.
JAX_GRAD = 1e-9
FP32_SUM_GRADS = 1e-7
FP32_PRODUCT_GRADS = 1e-6
LR_SPEC = ("cosine", 5e-3, LR)
CGA = tcga.CGA
PALLAS = dict(matmul_impl="pallas")
FUSED = dict(matmul_impl="fused", attn_impl="fused")
DROP = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)


def _cga_policy():
    return dataclasses.replace(w2a2_qkr_policy(DEPTH), qk_reparam_type=1,
                               boundary_range=0.005)


CASES = {
    "composed": dict(conf={}, lr=LR_SPEC, step_kw={}),
    "fused": dict(conf=FUSED, lr=LR_SPEC, step_kw={}),
    "pallas": dict(conf=PALLAS, lr=LR_SPEC, step_kw={}),
    "dropout": dict(conf=DROP, lr=LR_SPEC, step_kw={}, seed=7),
    "cga": dict(conf={}, policy=_cga_policy(),
                lr=("constant", tcga.LR, {}), step_kw=dict(cga=CGA)),
    "pallas_bf16": dict(conf=dict(PALLAS, compute_dtype="bfloat16"),
                        teacher_conf=dict(compute_dtype="bfloat16"),
                        teacher_bf16=True, dtype="float32", lr=LR_SPEC,
                        step_kw={}),
    "fused_bf16": dict(conf=dict(FUSED, compute_dtype="bfloat16"),
                       teacher_conf=dict(compute_dtype="bfloat16"),
                       teacher_bf16=True, dtype="float32", lr=LR_SPEC,
                       step_kw={}),
}
BF16_CASES = ("pallas_bf16", "fused_bf16")
FP64_CASES = ("composed", "fused", "pallas", "dropout", "cga")


# ------------------------------------------------------------ the setup
def _setup(tmp) -> dict:
    """Seeded weights (random, the shifts and heads drawn by numpy), the
    float teacher, the calibration and step batches, mid-run moments."""
    rng = np.random.default_rng(0)
    pol = w2a2_qkr_policy(DEPTH)
    m = create_model(tw.NAME, policy=pol, device="cpu",
                     generator=torch.Generator().manual_seed(3),
                     **tw.DIMS).double()
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith("bias"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.05))
            elif n.startswith("head") and n.endswith("kernel"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.2))
    t = create_model(tw.NAME, policy=QuantPolicy(), device="cpu",
                     generator=torch.Generator().manual_seed(4),
                     **tw.DIMS).double()
    shape = (B, 32, 32, 3)
    setup = dict(
        model_parallel=MP, dtype="float64", policy=pol,
        weights=m.state_dict(), teacher=t.state_dict(),
        calib=rng.normal(size=shape),
        batch={"image": rng.normal(size=shape),
               "label": rng.integers(0, 10, size=B)},
        mu={n: torch.from_numpy(rng.normal(size=p.shape) * 1e-3)
            for n, p in m.named_parameters()},
        nu={n: torch.from_numpy(rng.random(size=p.shape) * 1e-6)
            for n, p in m.named_parameters()},
        start=START, cases=CASES, checkpoint_case="composed",
        single_ckpt=os.path.join(tmp, "single"),
        kernel=rng.normal(size=(48, 6)))
    return setup


def _single_checkpoint(setup, calibrated):
    """The single process's checkpoint of the calibrated start (mp 1)."""
    m = tw._model(setup, {})
    m.load_state_dict(calibrated)
    st = TrainState.create(m, make_optimizer(lambda c: 1e-3))
    st.opt_state = dataclasses.replace(st.opt_state, count=START,
                                       mu=setup["mu"], nu=setup["nu"])
    st.step = START
    mgr = checkpoint.make_manager(setup["single_ckpt"])
    checkpoint.save_epoch(mgr, 0, st, {"top1": 0.0},
                          buffers=dict(m.named_buffers()))
    return checkpoint.load(mgr, 0)


RUNNER = ["--model", tw.NAME, "--img-size", "32", "--num-classes", "10",
          "--wq-enable", "--aq-enable", "--wq-bitw", "2", "--aq-bitw", "2",
          "--wq-per-channel", "--aq-per-channel", "--aq_clip_learnable",
          "--wq-mode", "statsq", "--quantized", "--qk_reparam",
          "--qk_reparam_type", "0", "--use-kd", "--teacher", tw.NAME,
          "--teacher_type", "deit", "--kd_hard_and_soft", "1", "--seed",
          "0", "--batch-size", "4", "--matmul-impl", "fused",
          "--attn-impl", "fused"]


def _launch(world, setup, tmp, mode):
    """`world` ranks of the worker over gloo (a timeout kills them); their
    results by rank."""
    path = os.path.join(tmp, "setup.pt")
    torch.save(setup, path)
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(FIXTURES, "tp_worker.py"), mode,
             path, tmp], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    whats = ["steps"] + (["runner"] if mode == "all" else [])
    return {w: [torch.load(os.path.join(tmp, f"{w}.rank{r}.pt"),
                           weights_only=False) for r in range(world)]
            for w in whats}


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The setup and the port's single-process results on the global
    batch."""
    tmp = str(tmp_path_factory.mktemp("tp_single"))
    setup = _setup(tmp)
    start = tw.calibrated_start(setup)
    payload = _single_checkpoint(setup, start["calibrated"])
    cases = {}
    for name, case in CASES.items():
        res = tw.run_case(setup, case, start["calibrated"])
        del res["state"], res["model"]
        cases[name] = res
    return dict(setup=setup, start=start, cases=cases, payload=payload)


@pytest.fixture(scope="module")
def world2(single, tmp_path_factory):
    """The world-2 launch (one model group of 2): the steps, then the
    Runner's fit and eval; the single-process eval of its checkpoint."""
    tmp = str(tmp_path_factory.mktemp("tp_world2"))
    out = os.path.join(tmp, "out")
    fit = ["synthetic", *RUNNER, "--steps-per-epoch", "2", "--epochs", "1",
           "--warmup-epochs", "0", "--cooldown-epochs", "0",
           "--log-interval", "1", "--output", out, "--experiment", "tp",
           "--mesh-model-parallel", "2"]
    ev = ["synthetic", *RUNNER, "--steps-per-epoch", "2", "--output",
          os.path.join(tmp, "ev"), "--resume", os.path.join(out, "tp"),
          "--experiment", "ev"]
    setup = dict(single["setup"], fit=fit,
                 eval=ev + ["--mesh-model-parallel", "2"])
    res = _launch(2, setup, tmp, "all")
    real = deit_models.VARIANTS[tw.NAME]
    tw.small_variant()
    try:
        res["single_eval"] = cli_eval.main(ev[:-2] + ["--experiment", "ev1"],
                                           device="cpu")
    finally:
        deit_models.VARIANTS[tw.NAME] = real
    res["out"] = out
    return res


@pytest.fixture(scope="module")
def world4(single, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_world4"))
    return _launch(4, single["setup"], tmp, "steps")


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def ranks(request, world2, world4):
    return (world2 if request.param == 2 else world4)["steps"]


# ------------------------------------------------------------- JAX's side
def _nest(named, dtype=np.float64):
    out: dict = {}
    for name, t in named.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        a = t.detach().numpy()
        node[leaf] = a.astype(dtype) if a.dtype.kind == "f" else a
    return out


def _jax_policy(cga=False):
    kw = dict(qk_reparam_type=1, boundary_range=0.005) if cga else {}
    return policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=True,
                            qmodules=default_deit_qmodules(DEPTH), **kw)


def _variables(calibrated):
    params = {k: v for k, v in calibrated.items() if not k.endswith("signed")}
    return {"params": _nest(params),
            "quant_stats": _nest({k: v for k, v in calibrated.items()
                                  if k.endswith("signed")})}


def _jax_run(single, name, conf):
    """JAX's single-device jitted step (x64) of case `name` from the
    calibrated start: its metrics, parameters, gradients (read off the
    moments) and, for CGA, the masks of the start."""
    setup, case = single["setup"], CASES[name]
    cga = "cga" in case["step_kw"]
    variables = _variables(single["start"]["calibrated"])
    dims = dict(embed_dim=32, num_heads=4, num_classes=10)
    jm = jax_deit_model(tw.NAME, _jax_policy(cga), **dims, **conf)
    sched = (jschedule.constant_lr(tcga.LR) if cga else
             jschedule.cosine_with_warmup_cooldown(5e-3, **LR))
    mu, nu = _nest(setup["mu"]), _nest(setup["nu"])
    with x64_jit():
        tx = jax_make_optimizer(sched, weight_decay=0.05)
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        step = jax.jit(jax_make_train_step(
            jm, tx, teacher=jax_deit_model(tw.NAME, **dims),
            loss_kind="kd_soft_hard", cga=CGA if cga else None))
        teacher = jax.tree.map(jnp.asarray, _nest(setup["teacher"]))
        new, met = step(jst, {k: jnp.asarray(v)
                              for k, v in setup["batch"].items()},
                        jax.random.key(0), teacher)
        out = dict(metrics={k: float(v) for k, v in met.items()},
                   params=_flat(jax.tree.map(np.asarray,
                                             new.params["params"])))
        mu1 = _flat(jax.tree.map(np.asarray, new.opt_state[0][0].mu))
        out["grads"] = {k: (v - 0.9 * _flat(mu)[k]) / 0.1
                        for k, v in mu1.items()}
        if cga:
            masks = jcga.freeze_masks(jax.tree.map(jnp.asarray,
                                                   variables["params"]),
                                      bits=2, boundary_range=0.005,
                                      qk_reparam=True)
            out["masks"] = {k: np.asarray(v) for k, v in
                            _flat(masks).items() if v.dtype != object}
        if name == "composed":
            logits, _ = jm.apply(jax.tree.map(jnp.asarray, variables),
                                 jnp.asarray(setup["batch"]["image"]),
                                 train=False)
            out["logits"] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def jax_refs(single):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        orig = jps.pallas_statsq_matmul
        mp.setattr(jps, "pallas_statsq_matmul",
                   lambda x, k, b, **kw: orig(x, k, b,
                                              **{**kw, "interpret": True}))
        for name, conf in (("composed", {}), ("cga", {}),
                           ("pallas", dict(matmul_impl="pallas"))):
            out[name] = _jax_run(single, name, conf)
    # JAX's fused kernels take fp32 only; its fused step is its composed
    # step's arithmetic (`test_torch_train_slice_fused`): the fused case is
    # held against the composed run, at FP32_PRODUCTS
    out["fused"] = out["composed"]
    return out


# ------------------------------------------------------------ the layout
@pytest.mark.parametrize("bits,all_positive", [(2, False), (2, True),
                                               (4, False)])
def test_row_parallel_k1_on_code_units_is_exact(bits, all_positive):
    """A row-parallel K1 runs the kernel on its codes' units (unit scales,
    w / s_w times 2n) and applies the epilogue after the group's sums: on
    one rank that is K1's plain version bit for bit, on inputs built with
    LSQ and StatsQ ties (`chip_smoke._k1_inputs`)."""
    import chip_smoke as cs
    from ofq_tpu_torch.ops import fused_qlinear as fq
    from ofq_tpu_torch.quant.lsq import thresholds
    g = torch.Generator().manual_seed(bits + all_positive)
    M, n_tok, K, N = 6 * 18, 18, 48, 40
    x, s, b_pre, w, b_post, bias = cs._k1_inputs(g, M, n_tok, K, N, bits,
                                                 bits, all_positive, "cpu")
    lo, hi = thresholds(bits, all_positive)
    n = float(2 ** (bits - 1))
    sw = statsq_scale(w)
    bvec = b_post @ fq._wq_value(w, sw, n)
    want = fq.fused_qlinear_fwd_reference(x, s, n_tok, b_pre, w, sw,
                                          bvec + bias, lo, hi, n)
    got = fq._row_parallel_forward(x, s, n_tok, b_pre, w, sw, bvec, bias,
                                   lo, hi, n, fq.fused_qlinear_fwd_reference,
                                   None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_rank_to_mesh_is_jaxs(world, world2, world4):
    """JAX's `np.asarray(devices).reshape(n // mp, mp)`: rank r at (r //
    mp, r % mp); the launches' meshes report it."""
    grid = np.arange(world).reshape(world // MP, MP)
    for r in range(world):
        d, m = map(int, np.argwhere(grid == r)[0])
        assert (r // MP, r % MP) == (d, m)
    if world in (2, 4):
        got = [r["mesh"] for r in (world2 if world == 2
                                   else world4)["steps"]]
        assert got == [(r // MP, r % MP, world // MP, MP)
                       for r in range(world)]


def test_shard_then_gather_is_the_identity(single):
    """Every cut of the student at 2 model ranks, reassembled in model
    order (what `Layout.gather` broadcasts), gives the full tensor back;
    `quan_qkx.s` is a strided slice (token n, head h at n * H + h)."""
    full = single["start"]["calibrated"]
    cuts = {}
    for name in ("blocks_0", "blocks_1"):
        cuts.update(tensor.block_cuts(name, 32, 4, 18, 128, MP))
    assert set(cuts) <= set(full) and len(cuts) == 2 * 18
    for n, c in cuts.items():
        parts = [c.local(full[n], m) for m in range(MP)]
        back = torch.cat([p.reshape(c.local_view) for p in parts],
                         dim=c.axis).reshape(c.shape)
        assert torch.equal(back, full[n]), n
    qkx = cuts["blocks_0.attn.quan_qkx.s"]
    s = full["blocks_0.attn.quan_qkx.s"].reshape(18, 4)
    assert torch.equal(qkx.local(full["blocks_0.attn.quan_qkx.s"], 1),
                       s[:, 2:].reshape(-1))


def test_group_statsq_scale_is_the_whole_kernels(world2, world4):
    """`statsq_scale(rows, mesh=...)` from each rank's rows of a (48, 6)
    kernel against `statsq_scale` of the whole kernel: the rows gathered
    over the model group, bit for bit."""
    for r in world2["steps"] + world4["steps"]:
        want, got = r["scale"]
        assert torch.equal(got, want)


def test_calibration_before_sharding_is_the_single_process(ranks, single):
    want = single["start"]["calibrated"]
    for r in ranks:
        assert set(r["calibrated"]) == set(want)
        for k, v in want.items():
            assert torch.equal(r["calibrated"][k], v), k


def test_eval_logits(ranks, single, jax_refs):
    """The sharded eval forward on each data index's rows: the single
    process's logits (the row-parallel sums in another order) and JAX's
    to 1e-9."""
    got = torch.cat([r["logits"] for r in ranks[::MP]])
    want = single["start"]["logits"]
    assert _rel_l2(got, want) <= SAME
    for r in ranks:
        assert torch.equal(r["logits"], ranks[r["mesh"][0] * MP]["logits"])
    np.testing.assert_allclose(got.numpy(), jax_refs["composed"]["logits"],
                               rtol=1e-9, atol=1e-9)


# ------------------------------------------------------------ the steps
def _limit(case, name):
    if name.endswith(".s") or ".move" in name or "_move" in name:
        return FP32_SUMS
    return FP32_SUMS if case in ("fused", "pallas") else SAME


@pytest.mark.parametrize("case", FP64_CASES)
def test_step_is_the_single_process_step(ranks, single, case):
    """Every parameter, gradient and moment after the step (gathered)
    against the single process's on the global batch; the loss to 1e-12
    and the gradient norm (of the full gradients) to 1e-9, or with the
    fp32 products of fused and pallas 1e-6 (measured 2.8e-8: 90 % of it
    is the head's weight-LSQ scale gradient, a sum that cancels)."""
    want = single["cases"][case]
    fp32 = case in ("fused", "pallas")
    for r in ranks:
        got = r[case]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= (
            1e-12 * abs(want["metrics"]["loss"]))
        assert abs(got["metrics"]["grad_norm"]
                   - want["metrics"]["grad_norm"]) <= (
            (1e-6 if fp32 else 1e-9) * want["metrics"]["grad_norm"])
        for key in ("params", "mu", "nu"):
            assert set(got[key]) == set(want[key])
            for k, w in want[key].items():
                assert got[key][k].shape == w.shape, (key, k)
                err = _rel_l2(got[key][k], w)
                lim = _limit(case, k) if key == "params" else 10 * FP32_SUMS
                assert err <= lim, (key, k, err)
        for k, w in want["grads"].items():
            if k.endswith(".s"):
                assert _rel_l2(got["grads"][k], w) <= SCALE_GRAD, k


def _fp32_summed(k):
    return k.endswith(".s") or "move" in k


def _jax_leaf_limit(case, k):
    if _fp32_summed(k):
        return tbn.SCALE_LEAF
    return FP32_PRODUCTS if case in ("fused", "pallas") else JAX_LEAF


@pytest.mark.parametrize("case", ["composed", "fused", "pallas", "cga"])
def test_step_matches_jax(world2, world4, jax_refs, case):
    """The step at world 2 and 4 against JAX's single-device jitted step
    (x64): the loss (1e-9) and gradient norm (1e-6: the fp32-summed LSQ
    scale gradients), every updated parameter and every gradient leaf."""
    ref = jax_refs[case]
    fp32 = case in ("fused", "pallas")
    for ranks in (world2["steps"], world4["steps"]):
        got = ranks[0][case]
        assert abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) <= (
            (1e-7 if fp32 else 1e-9) * abs(ref["metrics"]["loss"]))
        assert abs(got["metrics"]["grad_norm"]
                   - ref["metrics"]["grad_norm"]) <= (
            1e-5 * ref["metrics"]["grad_norm"])
        assert set(got["params"]) == set(ref["params"])
        for k, w in ref["params"].items():
            err = float(np.abs(got["params"][k].numpy() - w).max()) / max(
                1.0, float(np.abs(w).max()))
            assert err <= _jax_leaf_limit(case, k), (k, err)
        top = max(float(np.abs(g).max()) for g in ref["grads"].values())
        for k, w in ref["grads"].items():
            g = got["grads"][k].numpy()
            if k.endswith(".s"):
                assert _rel_l2(torch.from_numpy(g), torch.from_numpy(w)) <= (
                    SCALE_GRAD if not fp32 else 1e-3), k
            else:
                err = float(np.abs(g - w).max()) / top
                assert err <= (FP32_PRODUCT_GRADS if fp32 else
                               FP32_SUM_GRADS if _fp32_summed(k)
                               else JAX_GRAD), (k, err)


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_step(ranks, single, case):
    """The pallas and fused steps in the bf16 stream (the plain versions
    of K4, and of K1-K3; fp32 masters) against the single process under
    `test_torch_pallas_slice.test_slice_bf16`'s rule for the step (the
    model group rounds its all-reduced fp32 partial sums to bf16 once,
    the single process its whole sums, so a few levels move): the loss
    within 2 %, the gradient norm within 20 %, no parameter moved by more
    than 2.1 lr, at most 10 % of the elements (20 % of any one leaf) by
    more than lr / 4."""
    want = single["cases"][case]
    from ofq_tpu_torch.train import cosine_with_warmup_cooldown
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    for r in ranks:
        got = r[case]
        for k, lim in (("loss", 0.02), ("grad_norm", 0.2)):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= (
                lim * abs(want["metrics"][k])), k
        far = n = 0
        for k, w in want["params"].items():
            d = (got["params"][k] - w).abs().numpy()
            assert d.max() <= 2.1 * lr, k
            assert np.mean(d > lr / 4) <= 0.2, k
            far, n = far + int(np.sum(d > lr / 4)), n + d.size
        assert far <= 0.1 * n


@pytest.mark.parametrize("case", FP64_CASES + BF16_CASES)
def test_replicated_gradients_bit_equal_across_model_ranks(ranks, case):
    """Every gradient a rank holds whole (the parameters that stay whole)
    leaves the backward with the same bits on every rank of its model
    group; the gathered gradients and parameters are the same on every
    rank."""
    sliced = set(tensor.block_cuts("blocks_0", 32, 4, 18, 128, MP)) | set(
        tensor.block_cuts("blocks_1", 32, 4, 18, 128, MP))
    for r in ranks:
        mates = [q for q in ranks if q["mesh"][0] == r["mesh"][0]]
        a = r[case]["own_grads"]
        whole = [k for k in a if k not in sliced]
        assert len(whole) > 30
        for q in mates:
            for k in whole:
                assert torch.equal(a[k], q[case]["own_grads"][k]), k
            for key in ("grads", "params"):
                for k, v in r[case][key].items():
                    assert torch.equal(v, q[case][key][k]), (key, k)


def test_dropout_masks_are_the_global_draw_cut(ranks, single):
    """Each rank's masks are its data index's rows of the single
    process's and, where the tensor is sharded (the attention
    probabilities' heads, the MLP's hidden columns), its model index's
    slice; the replicated ones whole."""
    want = single["cases"]["dropout"]["drawn"]
    assert {a for _, a in want} == {None}
    for r in ranks:
        d, m, W, P = r["mesh"]
        got = r["dropout"]["drawn"]
        assert len(got) == len(want) > 8
        assert {a for _, a in got} == {None, 1, -1}
        for (g, axis), (w, _) in zip(got, want):
            n = w.shape[0] // W
            w = w[d * n:(d + 1) * n]
            if axis is not None:
                k = w.shape[axis] // P
                w = w.narrow(axis % w.ndim, m * k, k)
            assert torch.equal(g, w)


def test_cga_masks_are_the_single_process_masks(ranks, single, jax_refs):
    want = single["cases"]["cga"]["masks"]
    jmasks = jax_refs["cga"]["masks"]
    assert len(want) == 4 * DEPTH and set(want) == set(jmasks)
    for r in ranks:
        got = r["cga"]["masks"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert torch.equal(got[k], w), k
            np.testing.assert_array_equal(got[k].numpy(), jmasks[k])
    share = np.mean([(m == 0).float().mean().item() for m in want.values()])
    assert 0 < share < 0.1


# -------------------------------------------------------- checkpoints
def _same_tree(got, want, path=""):
    """Every tensor, number and string of two checkpoint payloads equal
    (tensors in shape, dtype and bits)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif torch.is_tensor(want):
        assert (got.shape, got.dtype) == (want.shape, want.dtype), path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_checkpoints_round_trip(ranks, single):
    """The sharded start's file is the file one process writes for the
    same state (every tensor bit-equal); a rank's file after the step
    read back into it; that file holds the single process's names,
    shapes and dtypes and restores into a single process's state (mp 2
    -> mp 1) as the gathered state; the single process's file restores
    into the shards as their cut (mp 1 -> mp 2)."""
    setup = single["setup"]
    for r in ranks:
        assert r["checkpoints"]["round_trip"]
    c0 = ranks[0]["checkpoints"]
    _same_tree(checkpoint.load(checkpoint.make_manager(c0["start_dir"]), 0),
               single["payload"])
    payload = checkpoint.load(checkpoint.make_manager(c0["dir"]), 0)
    ref = single["payload"]
    for key in ("params", "buffers"):
        assert {k: (v.shape, v.dtype) for k, v in payload[key].items()} == {
            k: (v.shape, v.dtype) for k, v in ref[key].items()}
    for key in ("mu", "nu"):
        assert {k: v.shape for k, v in payload["opt_state"][key].items()} \
            == {k: v.shape for k, v in ref["opt_state"][key].items()}
    m = tw._model(setup, {})
    st = TrainState.create(m, make_optimizer(lambda c: 1e-3))
    checkpoint.restore_into(payload, st, m)
    for k, v in ranks[0]["composed"]["params"].items():
        assert torch.equal(st.params[k], v), k
    layout = tensor.Layout(None, {})
    for name in ("blocks_0", "blocks_1"):
        layout.cuts.update(tensor.block_cuts(name, 32, 4, 18, 128, MP))
    for r in ranks:
        m_idx = r["mesh"][1]
        got = r["checkpoints"]["from_single"]
        for key, full in (("params", ref["params"]),
                          ("mu", ref["opt_state"]["mu"])):
            for k, v in full.items():
                c = layout.cuts.get(k)
                want = v if c is None else c.local(v, m_idx)
                assert torch.equal(got[key][k], want.to(got[key][k].dtype)), k


# ------------------------------------------------------------- the runner
def test_runner_world2_trains_and_evaluates(world2):
    """`--mesh-model-parallel 2` at world 2: both ranks take the whole
    batch of 4 (one data index), rank 0 writes the checkpoint, the ranks'
    sliced parameters differ and the whole ones agree, and
    `cli.eval.main` at mp 2 on that checkpoint gives the single-process
    eval's top-1 and top-5."""
    r0, r1 = world2["runner"]
    assert r0["batch"] == r1["batch"] == 4
    assert r0["shard"] == r1["shard"] == (0, 1)
    assert sorted(os.listdir(os.path.join(world2["out"], "tp"))) == [
        "0", "args.yaml", "summary.csv"]
    same = [k for k in r0["params"]
            if r0["params"][k].shape == r1["params"][k].shape
            and torch.equal(r0["params"][k], r1["params"][k])]
    assert "blocks_0.attn.q_kernel" not in same and "head.kernel" in same
    single = world2["single_eval"]
    for got in (r0["eval"], r1["eval"]):
        assert (got["top1"], got["top5"]) == (single["top1"],
                                              single["top5"])
        assert abs(got["loss"] - single["loss"]) <= 1e-5 * abs(
            single["loss"])


# ------------------------------------------------------------ refusals
def _fake_mesh(world=2, mp=MP):
    return Mesh(world=world, rank=0, local_rank=0,
                device=torch.device("cpu"), model_parallel=mp)


def _small(policy=None, **conf):
    return create_model(tw.NAME, policy=policy or w2a2_qkr_policy(DEPTH),
                        device="cpu", **{**tw.DIMS, **conf})


REFUSED_MODELS = {
    "swin": (lambda: create_model(
        "swin_test", policy=QuantPolicy(), device="cpu"), "7.2c"),
    "no_qkr": (lambda: _small(w2a2_deit_policy(DEPTH, qk_reparam=False)),
               "7.2d"),
    "int8": (lambda: _small(matmul_impl="int8"), "7.2e"),
    "full_lsq": (lambda: _small(w2a2_deit_policy(DEPTH, wq_mode="lsq")),
                 "7.2f"),
    "telemetry": (lambda: _small(qqkkvv=True), "7.2g"),
    "remat": (lambda: _small(remat=True), "7.2h"),
    "attn_remat": (lambda: _small(attn_impl="remat"), "7.2h"),
    "batchnorm": (lambda: _small(norm_layer="batchnorm"), "7.2i"),
    "frozen": (lambda: _small(dataclasses.replace(
        w2a2_qkr_policy(DEPTH), weight_frozen=True)), "7.2j"),
    "prelu": (lambda: _small(dataclasses.replace(
        w2a2_qkr_policy(DEPTH), act_layer="prelu")), "7.2k"),
    "float": (lambda: _small(QuantPolicy()), "7.2k"),
}


@pytest.mark.parametrize("what", sorted(REFUSED_MODELS))
def test_unported_models_refuse(what):
    make, item = REFUSED_MODELS[what]
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {item}"):
        parallel.shard_model(make(), _fake_mesh())


STEP_REFUSALS = {
    "kd_qk": dict(loss_kind="kd_qk"),
    "ema": dict(ema_decay=0.99),
    "bf16_masters": dict(master_dtype="bfloat16"),
    "oscillation": dict(oscillation=dict(bits=2)),
    "grad_norms": dict(per_layer_grad_norms=True),
    "dampening": dict(dampening=dict(bits=2, weighting=0.1)),
    "clipping": dict(clip=1.0),
}


@pytest.mark.parametrize("what", sorted(STEP_REFUSALS))
def test_unported_step_options_refuse(what):
    """The step's options not ported at mp > 1 (ROADMAP item 7.2g), on a
    sharded model; serving a sharded model (7.2j)."""
    m = _small()
    parallel.shard_model(m, _fake_mesh())
    kw = dict(STEP_REFUSALS[what])
    opt = make_optimizer(lambda c: 1e-3, clip_grad=kw.pop("clip", None))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.2g"):
        make_train_step(m, opt, teacher=_small(QuantPolicy()),
                        device="cpu", mesh=_fake_mesh(), **kw)


def test_sharded_serving_and_bf16_state_refuse():
    m = _small()
    parallel.shard_model(m, _fake_mesh())
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.2j"):
        Predictor(m, batch_size=2, img_size=32, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.2g"):
        TrainState.create(m, make_optimizer(lambda c: 1e-3),
                          master_dtype="bfloat16")
    with pytest.raises(ValueError, match="sharded already"):
        parallel.shard_model(m, _fake_mesh())


@pytest.mark.parametrize("world,mp,heads", [(2, 3, 4), (4, 4, 6), (2, 2, 3)])
def test_model_parallel_must_divide(world, mp, heads):
    """An mp that does not divide the world (make_mesh) or the heads
    (shard_model) raises ValueError."""
    if world % mp:
        with pytest.raises(ValueError, match="does not divide"):
            parallel.make_mesh(model_parallel=mp, device="cpu")
    else:
        m = _small(embed_dim=8 * heads, num_heads=heads)
        with pytest.raises(ValueError, match="does not divide"):
            parallel.shard_model(m, _fake_mesh(world, mp))
    assert common.parse_args(["synthetic", "--mesh-model-parallel",
                              str(mp)]).mesh_model_parallel == mp
