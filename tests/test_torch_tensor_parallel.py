"""Tensor parallelism (`ofq_tpu_torch.parallel`'s 'model' axis) on the CPU:
the small DeiT W2A2 QKR student (depth 2, embed 32, 4 heads, image 32,
patch 8, distilled, 10 classes) at world 2 (one model group of 2) and at
world 4 (2 data x 2 model), over gloo, in fp64, each rank a process of
`torch_fixtures/tp_worker.py` (which imports no JAX); this process
computes the port's single-process results and JAX's.  The same two
launches also run the other students (`CONFIGS`): the `swin_test` W2A2
student with and without QKR at heads (3, 4), depths (2, 2) and 2 x 2
windows (stage 0's 3 heads stay whole at 2 ranks, stage 1's 4 are cut;
both stages' second blocks shifted), DeiT-T's 3 heads (every attention
whole, every MLP cut) and the DeiT student without QKR (`qkv` cut by
head) and the DeiT student without QKR under full-LSQ weights (`--wq-mode
lsq`: the weight scales of the column cuts cut, of the row cuts whole);
for each, the eval logits, the steps against the single process and
JAX's jitted step, the replicated gradients across the model ranks,
CGA's masks, checkpoints and the layout; the world-2 launch also takes
the Swin student through `cli.train`, `cli.cga` and `cli.eval` at
`--mesh-model-parallel 2`.

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
  * the int8 core (`matmul_impl="int8"`, the products on the integer
    codes; DeiT with and without QKR, Swin with QKR) in fp32: the eval
    logits bit-equal to the single process's (the row-parallel int32
    sums are exact, the epilogue runs once), the step against the single
    process (INT8_LEAF) and JAX's jitted int8 step (`test_torch_int8_
    slice.test_step_fp32`'s rule: JAX's int8 VJP cannot run under x64);
  * the step's options, several at once over two steps (`OPTION_CASES`:
    `kd_qk` / `kd_qkv` / `kd_token`, the EMA, AGC / norm / value
    clipping, bf16 masters, the oscillation hook, per-layer gradient
    norms, the dampening loss), each option's leaves a case of its own
    against the single process, and `kd_qkv` with the dampening loss
    against JAX's jitted step (x64); faults: a row-parallel full-LSQ
    weight scale's grad-scale factor at its slice's shape, the dampening
    loss's whole kernels counted once per rank;
  * the refusals of the configurations not ported at mp > 1, each naming
    its ROADMAP item; a width that divides neither a block's heads nor
    its MLP refused, one that divides the MLP only keeping the attention
    whole.
"""

import dataclasses
import math
import os
import subprocess
import sys
import time

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

from ofq_tpu.models import swin as jswin
from ofq_tpu.models.deit import deit_model as jax_deit_model
from ofq_tpu.ops import pallas_statsq as jps
from ofq_tpu.quant import (default_deit_qmodules, default_swin_qmodules,
                           policy_from_args)
from ofq_tpu.train import cga as jcga
from ofq_tpu.train import make_optimizer as jax_make_optimizer
from ofq_tpu.train import make_train_step as jax_make_train_step
from ofq_tpu.train import schedule as jschedule
from ofq_tpu_torch import parallel
from ofq_tpu_torch.cli import common
from ofq_tpu_torch.cli import eval as cli_eval
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.models import deit as deit_models
from ofq_tpu_torch.models import swin as swin_models
from ofq_tpu_torch.parallel import Mesh, tensor
from ofq_tpu_torch.quant import (QuantPolicy, QuantSpec, statsq_scale,
                                 w2a2_deit_policy, w2a2_qkr_policy,
                                 w2a2_qkr_swin_policy, w2a2_swin_policy)
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
INT8 = dict(matmul_impl="int8")
DROP = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1)
GRAMS = dict(qqkkvv=True)
OSC = dict(bits=2, momentum=0.3, freeze_threshold=0.05)
DAMP = dict(bits=2, weighting=0.05)


# dropout and drop-path without attention dropout: the checkpointed tail
# runs in train mode
DROP_TAIL = dict(drop_rate=0.1, drop_path_rate=0.1)
BN = dict(norm_layer="batchnorm")


def _cga_policy():
    return dataclasses.replace(w2a2_qkr_policy(DEPTH), qk_reparam_type=1,
                               boundary_range=0.005)


def _qkr_policy(**kw):
    """The DeiT student's W2A2 QKR policy with `kw` replaced: 32-bit
    weights or inputs, an unquantized softmax (`q_attn_mode`), another
    MLP activation."""
    return dataclasses.replace(w2a2_qkr_policy(DEPTH), **kw)


BITS_32 = QuantSpec(mode="identity", bit=32)


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
    # the int8 core in fp32, with the eval logits of its start
    "int8": dict(conf=INT8, dtype="float32", lr=LR_SPEC, step_kw={},
                 eval=True),
    # kd_qkv and the dampening loss, held against JAX too
    "telemetry": dict(conf=GRAMS, teacher_conf=GRAMS, lr=LR_SPEC,
                      step_kw=dict(loss_kind="kd_qkv", dampening=DAMP)),
    # several options at once, two steps
    "options": dict(conf=GRAMS, teacher_conf=GRAMS, lr=LR_SPEC, steps=2,
                    ema=True, clip=0.02, clip_mode="agc",
                    step_kw=dict(loss_kind="kd_qk", ema_decay=0.9,
                                 dampening=DAMP, per_layer_grad_norms=True,
                                 oscillation=dict(OSC, qk_reparam=True,
                                                  model_type="deit"))),
    "options_norm": dict(conf=dict(return_features=True),
                         teacher_conf=dict(return_features=True),
                         lr=LR_SPEC, steps=2, ema=True, clip=0.05,
                         step_kw=dict(loss_kind="kd_token", ema_decay=0.9,
                                      per_layer_grad_norms=True)),
    # bf16 masters (fp32 working parameters), value clipping
    "options_bf16": dict(conf=GRAMS, teacher_conf=GRAMS, dtype="float32",
                         lr=LR_SPEC, steps=2, master_dtype="bfloat16",
                         clip=1e-3, clip_mode="value",
                         step_kw=dict(loss_kind="kd_qkv", dampening=DAMP,
                                      master_dtype="bfloat16")),
    # block remat with dropout on: `dropout`'s step, its blocks replayed
    "remat": dict(conf=dict(DROP, remat=True), lr=LR_SPEC, step_kw={},
                  seed=7, eval=True),
    # the fused configuration's blocks replayed (K1-K3's plain versions,
    # the row-parallel integer sums reissued in the backward)
    "remat_fused": dict(conf=dict(FUSED, **DROP_TAIL, remat=True),
                        lr=LR_SPEC, step_kw={}, seed=7),
    # the checkpointed attention tail
    "attn_remat": dict(conf=dict(DROP_TAIL, attn_impl="remat"), lr=LR_SPEC,
                       step_kw={}, seed=7, eval=True),
    # the LN->BN swap (running statistics at their initial values)
    "batchnorm": dict(conf=BN, lr=LR_SPEC, step_kw={}, loose=True,
                      eval=True, buffers_checkpoint=True),
    # the float student (`qkv`, `proj`, `fc1`, `fc2` Dense, GELU)
    "float": dict(conf={}, policy=QuantPolicy(), start="float_weights",
                  moments="float_", lr=LR_SPEC, step_kw={}, eval=True),
    # 32-bit weights (every StatsQ site unquantized) and 32-bit inputs
    # (every activation quantizer of the blocks absent)
    "w32": dict(conf={}, policy=_qkr_policy(weight=BITS_32), lr=LR_SPEC,
                step_kw={}),
    "a32": dict(conf={}, policy=_qkr_policy(act=BITS_32), lr=LR_SPEC,
                step_kw={}, loose=True),
    # the softmax unquantized (--apply_q_attn_dropout 1)
    "softmax_float": dict(conf={}, policy=_qkr_policy(q_attn_mode=1),
                          lr=LR_SPEC, step_kw={}, loose=True),
    "prelu": dict(conf={}, policy=_qkr_policy(act_layer="prelu"),
                  lr=LR_SPEC, step_kw={}, loose=True, eval=True),
    "rprelu": dict(conf={}, policy=_qkr_policy(act_layer="rprelu"),
                   extra="rprelu", lr=LR_SPEC, step_kw={}),
    # the checkpointed tail in the bf16 stream (a sharded QKR attention's
    # fp32 lhs against the bf16 qkx, `score_product`)
    "remat_bf16": dict(conf=dict(PALLAS, compute_dtype="bfloat16",
                                 attn_impl="remat"),
                       teacher_conf=dict(compute_dtype="bfloat16"),
                       teacher_bf16=True, dtype="float32", lr=LR_SPEC,
                       step_kw={}),
}
BF16_CASES = ("pallas_bf16", "fused_bf16", "options_bf16", "remat_bf16")
FP32_CASES = ("int8",)
OPTION_CASES = ("telemetry", "options", "options_norm")
# the configurations the earlier slices refused at model_parallel > 1
NEW_CASES = ("remat", "remat_fused", "attn_remat", "batchnorm", "float",
             "w32", "a32", "softmax_float", "prelu", "rprelu")
FP64_CASES = (("composed", "fused", "pallas", "dropout", "cga")
              + OPTION_CASES + NEW_CASES)
# the cases whose models are cut otherwise than the W2A2 student
OTHER_CUTS = ("float", "rprelu")
# the cases whose products the plain versions form in fp32
FP32_PRODUCT_CASES = ("fused", "pallas", "remat_fused", "remat_pallas")

# the other students, each launched with the DeiT one: (model name, its
# dimensions, family, QKR, the cases it steps)
DEIT_T = dict(embed_dim=24, num_heads=3, num_classes=10)
SWIN_DEPTHS = tw.SWIN_DIMS["depths"]
CONFIGS = {
    # Swin-T's head layout cut small: a 3-head stage (whole at 2 ranks)
    # and a 4-head stage (cut)
    "swin_qkr": dict(name=tw.SWIN, dims=tw.SWIN_DIMS, family="swin",
                     qkr=True, cases=("composed", "pallas", "dropout", "cga",
                                      "pallas_bf16", "int8", "options",
                                      "remat", "remat_pallas", "attn_remat",
                                      "remat_bf16", "batchnorm", "float",
                                      "rprelu"),
                     faults={f: "composed" for f in tw.FAULTS}),
    "swin": dict(name=tw.SWIN, dims=tw.SWIN_DIMS, family="swin", qkr=False,
                 cases=("composed", "dropout", "cga", "prelu")),
    # DeiT-T's 3 heads: every attention whole, every MLP cut
    "deit_t": dict(name=tw.NAME, dims=DEIT_T, family="deit", qkr=True,
                   cases=("composed", "fused", "cga", "options"),
                   faults={"dampening_whole_per_rank": "options"}),
    # `qkv` cut by head
    "deit_no_qkr": dict(name=tw.NAME, dims=tw.DIMS, family="deit",
                        qkr=False, cases=("composed", "fused", "cga", "int8")),
    # full-LSQ weights (learnable weight scales) without QKR: qkv and fc1
    # cut with their scales, proj and fc2 by rows with their whole scales
    "deit_lsq": dict(name=tw.NAME, dims=tw.DIMS, family="deit", qkr=False,
                     lsq=True, cases=("composed",),
                     faults={"lsq_weight_grad_scale_local": "composed"}),
}
CONFIG_FP64 = [(k, c) for k, v in CONFIGS.items() for c in v["cases"]
               if c not in BF16_CASES + FP32_CASES]
CONFIG_INT8 = [k for k, v in CONFIGS.items() if "int8" in v["cases"]]
CONFIG_BF16 = [(k, c) for k, v in CONFIGS.items() for c in v["cases"]
               if c in BF16_CASES]
CONFIG_JAX = [(k, c) for k, c in CONFIG_FP64 if c in ("composed", "fused")]
CONFIG_DROPOUT = [k for k, v in CONFIGS.items() if "dropout" in v["cases"]]


def _lsq_flags(c):
    """The full-LSQ config's policy flags: learnable weight scales."""
    return dict(wq_mode="lsq", wq_learnable=True) if c.get("lsq") else {}


def _port_policy(key):
    c = CONFIGS[key]
    if c.get("lsq"):
        from ofq_tpu_torch.quant import default_deit_qmodules
        from ofq_tpu_torch.quant.policy import W2A2_FLAGS
        from ofq_tpu_torch.quant.policy import \
            policy_from_args as port_policy
        return port_policy(**dict(W2A2_FLAGS, qk_reparam=False,
                                  **_lsq_flags(c)),
                           qmodules=default_deit_qmodules(DEPTH))
    if c["family"] == "swin":
        return (w2a2_qkr_swin_policy(SWIN_DEPTHS) if c["qkr"] else
                w2a2_swin_policy(SWIN_DEPTHS, qk_reparam=False))
    return (w2a2_qkr_policy(DEPTH) if c["qkr"] else
            w2a2_deit_policy(DEPTH, qk_reparam=False))


def _config_cga(key):
    c = CONFIGS[key]
    return dict(bits=2, boundary_range=0.005, qk_reparam=c["qkr"],
                model_type=c["family"])


def _config_cases(key):
    c = CONFIGS[key]
    pol = dataclasses.replace(_port_policy(key), boundary_range=0.005,
                              **(dict(qk_reparam_type=1) if c["qkr"]
                                 else {}))
    cases = dict(CASES, cga=dict(conf={}, policy=pol,
                                 lr=("constant", tcga.LR, {}),
                                 step_kw=dict(cga=_config_cga(key))))
    opts = cases["options"]
    kw = dict(opts["step_kw"], oscillation=dict(
        OSC, qk_reparam=c["qkr"], model_type=c["family"]))
    if c["family"] == "swin":
        # the quantized window attentions give no Grams (JAX's neither):
        # Swin's options step distils the logits
        kw.pop("loss_kind")
        opts = dict(opts, conf={}, teacher_conf={})
    cases["options"] = dict(opts, step_kw=kw)
    if c["family"] == "swin":
        base = _port_policy(key)
        cases.update(
            # the blocks of both stages replayed (K4's plain version: the
            # row-parallel products and the gathered StatsQ scales
            # reissued in the backward)
            remat=dict(CASES["remat"], conf=dict(DROP, remat_stages=(0, 1))),
            remat_pallas=dict(CASES["remat_fused"],
                              conf=dict(PALLAS, **DROP_TAIL,
                                        remat_stages=(0, 1))),
            float=dict(CASES["float"], policy=QuantPolicy()),
            prelu=dict(CASES["prelu"],
                       policy=dataclasses.replace(base, act_layer="prelu")),
            rprelu=dict(CASES["rprelu"],
                        policy=dataclasses.replace(base,
                                                   act_layer="rprelu")))
    return {k: cases[k] for k in c["cases"]}


# ------------------------------------------------------------ the setup
def _weights(name, dims, pol, rng):
    """A seeded student (the shifts, biases, bias tables and head drawn
    by `rng`) and its float teacher, fp64 state dicts."""
    m = create_model(name, policy=pol, device="cpu",
                     generator=torch.Generator().manual_seed(3),
                     **dims).double()
    with torch.no_grad():
        for n, p in m.named_parameters():
            if n.endswith("bias"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.05))
            elif n.endswith("bias_table"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.5))
            elif n.startswith("head") and n.endswith("kernel"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.2))
    t = create_model(name, policy=QuantPolicy(), device="cpu",
                     generator=torch.Generator().manual_seed(4),
                     **dims).double()
    return m, t


def _float_student(name, dims, rng):
    """A float student of the teacher's structure, seeded apart from it,
    its biases drawn by `rng`."""
    f = create_model(name, policy=QuantPolicy(), device="cpu",
                     generator=torch.Generator().manual_seed(5),
                     **dims).double()
    with torch.no_grad():
        for n, p in f.named_parameters():
            if n.endswith("bias") or n.endswith("bias_table"):
                p.copy_(torch.from_numpy(rng.normal(size=p.shape) * 0.1))
    return f.state_dict()


def _rprelu(m, rng) -> dict:
    """An RPReLU's per-channel shifts and slopes for each quantized MLP of
    `m` (drawn by `rng`)."""
    out = {}
    for n, p in m.named_parameters():
        if n.endswith(".mlp.fc1.bias"):
            hid = p.shape[0]
            pre = n[:-len("fc1.bias")]
            out[pre + "act.move1"] = torch.from_numpy(
                rng.normal(size=hid) * 0.1)
            out[pre + "act.alpha"] = torch.from_numpy(
                rng.uniform(0.05, 0.5, size=hid))
            out[pre + "act.move2"] = torch.from_numpy(
                rng.normal(size=hid) * 0.1)
    return out


def _data(name, dims, m, t, rng) -> dict:
    shape = (B, 32, 32, 3)
    out = dict(
        weights=m.state_dict(), teacher=t.state_dict(),
        calib=rng.normal(size=shape),
        batch={"image": rng.normal(size=shape),
               "label": rng.integers(0, 10, size=B)},
        mu={n: torch.from_numpy(rng.normal(size=p.shape) * 1e-3)
            for n, p in m.named_parameters()},
        nu={n: torch.from_numpy(rng.random(size=p.shape) * 1e-6)
            for n, p in m.named_parameters()})
    # the float student's start and moments, the RPReLUs' shifts and
    # slopes (drawn after the rest: the other cases' data stay as they were)
    fl = _float_student(name, dims, rng)
    out.update(
        float_weights=fl, rprelu=_rprelu(m, rng),
        float_mu={n: torch.from_numpy(rng.normal(size=p.shape) * 1e-3)
                  for n, p in fl.items()},
        float_nu={n: torch.from_numpy(rng.random(size=p.shape) * 1e-6)
                  for n, p in fl.items()})
    return out


def _config_setup(key, tmp) -> dict:
    c = CONFIGS[key]
    rng = np.random.default_rng(10 + sorted(CONFIGS).index(key))
    pol = _port_policy(key)
    m, t = _weights(c["name"], c["dims"], pol, rng)
    return dict(name=c["name"], dims=c["dims"], model_parallel=MP,
                dtype="float64", policy=pol, start=START,
                cases=_config_cases(key), checkpoint_case="composed",
                faults=c.get("faults", {}),
                single_ckpt=os.path.join(tmp, key, "single"),
                **_data(c["name"], c["dims"], m, t, rng))


def _setup(tmp) -> dict:
    """Seeded weights (random, the shifts and heads drawn by numpy), the
    float teacher, the calibration and step batches, mid-run moments;
    the same for each of CONFIGS."""
    rng = np.random.default_rng(0)
    pol = w2a2_qkr_policy(DEPTH)
    m, t = _weights(tw.NAME, tw.DIMS, pol, rng)
    setup = dict(
        model_parallel=MP, dtype="float64", policy=pol,
        **_data(tw.NAME, tw.DIMS, m, t, rng),
        start=START, cases=CASES, checkpoint_case="composed",
        single_ckpt=os.path.join(tmp, "single"),
        kernel=rng.normal(size=(48, 6)),
        configs={k: _config_setup(k, tmp) for k in CONFIGS})
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


SWIN_RUNNER = ["synthetic", "--model", tw.SWIN, "--model_type", "swin",
               "--img-size", "32", "--num-classes", "10", "--batch-size",
               "4", "--steps-per-epoch", "2", "--warmup-epochs", "0",
               "--cooldown-epochs", "0", "--mixup", "0", "--cutmix", "0",
               "--wq-enable", "--aq-enable", "--wq-bitw", "2", "--aq-bitw",
               "2", "--wq-per-channel", "--aq-per-channel",
               "--aq_clip_learnable", "--quantized", "--qk_reparam",
               "--seed", "0", "--log-interval", "1", "--matmul-impl",
               "pallas"]
SWIN_CGA = ["--qk_reparam_type", "1", "--boundaryRange", "0.005",
            "--freeze_for_n_epochs", "1", "--steps-per-epoch", "1"]
RUNNER = ["--model", tw.NAME, "--img-size", "32", "--num-classes", "10",
          "--wq-enable", "--aq-enable", "--wq-bitw", "2", "--aq-bitw", "2",
          "--wq-per-channel", "--aq-per-channel", "--aq_clip_learnable",
          "--wq-mode", "statsq", "--quantized", "--qk_reparam",
          "--qk_reparam_type", "0", "--use-kd", "--teacher", tw.NAME,
          "--teacher_type", "deit", "--kd_hard_and_soft", "1", "--seed",
          "0", "--batch-size", "4", "--matmul-impl", "fused",
          "--attn-impl", "fused"]


def _start(world, setup, tmp, mode):
    """`world` ranks of the worker over gloo, started (each rank's output
    to a file); `_finish` waits for them."""
    path = os.path.join(tmp, "setup.pt")
    torch.save(setup, path)
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        with open(os.path.join(tmp, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(FIXTURES, "tp_worker.py"),
                 mode, path, tmp], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return dict(procs=procs, tmp=tmp, mode=mode, world=world,
                deadline=time.monotonic() + LAUNCH_TIMEOUT)


def _finish(started):
    """The started ranks' results by rank (a rank still running at the
    deadline is killed)."""
    procs, tmp = started["procs"], started["tmp"]
    try:
        for p in procs:
            p.wait(timeout=max(started["deadline"] - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                out = f.read()
            raise AssertionError(f"rank {r} (exit {p.returncode}):\n"
                                 f"{out[-4000:]}")
    whats = ["steps"] + (["runner"] if started["mode"] == "all" else [])
    return {w: [torch.load(os.path.join(tmp, f"{w}.rank{r}.pt"),
                           weights_only=False)
                for r in range(started["world"])]
            for w in whats}


def _single_start(setup) -> dict:
    """The port's single-process calibrated start and its checkpoint (mp
    1), which the ranks restore, of a setup."""
    start = tw.calibrated_start(setup)
    return dict(setup=setup, start=start,
                payload=_single_checkpoint(setup, start["calibrated"]))


def _single_cases(res) -> dict:
    """`res` with the single process's step of every case of its setup on
    the global batch."""
    cases = {}
    for name, case in res["setup"]["cases"].items():
        step = tw.run_case(res["setup"], case, res["start"]["calibrated"])
        del step["state"], step["model"]
        cases[name] = step
    return dict(res, cases=cases)


def _world2_setup(setup, tmp):
    """The world-2 launch's setup: the steps' and the commands' argv (the
    DeiT Runner's fit and eval; the Swin student's train, CGA and eval);
    the single-process evals' argv."""
    out = os.path.join(tmp, "out")
    fit = ["synthetic", *RUNNER, "--steps-per-epoch", "2", "--epochs", "1",
           "--warmup-epochs", "0", "--cooldown-epochs", "0",
           "--log-interval", "1", "--output", out, "--experiment", "tp",
           "--mesh-model-parallel", "2"]
    ev = ["synthetic", *RUNNER, "--steps-per-epoch", "2", "--output",
          os.path.join(tmp, "ev"), "--resume", os.path.join(out, "tp"),
          "--experiment", "ev"]
    sw_out = os.path.join(tmp, "swin")
    mp2 = ["--mesh-model-parallel", "2"]
    sw_ev = SWIN_RUNNER + ["--output", os.path.join(tmp, "sw_ev"),
                           "--resume", os.path.join(sw_out, "cga"),
                           "--experiment", "ev"]
    swin = dict(
        fit=SWIN_RUNNER + ["--epochs", "1", "--output", sw_out,
                           "--experiment", "p1"] + mp2,
        cga=SWIN_RUNNER + SWIN_CGA + ["--output", sw_out, "--experiment",
                                      "cga", "--resume",
                                      os.path.join(sw_out, "p1")] + mp2,
        eval=sw_ev + mp2)
    base = [a for a in fit if a not in ("--experiment", "tp")]
    option_fits = {
        # the int8 core with every option of the step the CLI sets
        "int8_options": base + [
            "--experiment", "opt", "--matmul-impl", "int8",
            "--kd_hard_and_soft", "3", "--model-ema", "--clip-grad", "0.02",
            "--clip-mode", "agc", "--master-dtype", "bfloat16",
            "--track-oscillation", "--wandb-watch",
            "--dampening-loss-weighting", "0.05"],
        "lsq": base + ["--experiment", "lsq", "--wq-mode", "lsq",
                       "--clip-grad", "0.5", "--clip-mode", "value"]}
    return (dict(setup, fit=fit, eval=ev + mp2, swin=swin,
                 option_fits=option_fits),
            dict(out=out, swin_out=sw_out, ev=ev, sw_ev=sw_ev))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The setup, the single process's starts and checkpoints, and the
    world-2 (one model group of 2: the steps, then the Runner and the Swin
    commands) and world-4 (2 data x 2 model: the steps) launches, started
    together; the fixtures below compute the single process's and JAX's
    results while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("tp_single"))
    setup = _setup(tmp)
    starts = dict(_single_start(setup),
                  configs={k: _single_start(c)
                           for k, c in setup["configs"].items()})
    t2 = str(tmp_path_factory.mktemp("tp_world2"))
    setup2, paths = _world2_setup(setup, t2)
    out = dict(starts=starts, paths=paths,
               world2=_start(2, setup2, t2, "all"),
               world4=_start(4, setup, str(tmp_path_factory.mktemp(
                   "tp_world4")), "steps"))
    yield out
    for key in ("world2", "world4"):
        for p in out[key]["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def single(launched):
    """The setup and the port's single-process results on the global
    batch, for the DeiT student and each of CONFIGS (`configs`)."""
    starts = launched["starts"]
    out = _single_cases(starts)
    out["configs"] = {k: _single_cases(c)
                      for k, c in starts["configs"].items()}
    return out


@pytest.fixture(scope="module")
def world2(launched, single, jax_refs, config_jax):
    """The world-2 launch's results, then the single-process evals of its
    checkpoints (the JAX references are computed before the wait)."""
    res = _finish(launched["world2"])
    paths = launched["paths"]
    real = (deit_models.VARIANTS[tw.NAME], swin_models.VARIANTS[tw.SWIN])
    tw.small_variant()
    try:
        res["single_eval"] = cli_eval.main(
            paths["ev"][:-2] + ["--experiment", "ev1"], device="cpu")
        res["swin_single_eval"] = cli_eval.main(
            paths["sw_ev"][:-2] + ["--experiment", "ev1"], device="cpu")
    finally:
        deit_models.VARIANTS[tw.NAME], swin_models.VARIANTS[tw.SWIN] = real
    res["out"] = paths["out"]
    res["swin_out"] = paths["swin_out"]
    return res


@pytest.fixture(scope="module")
def world4(launched, world2):
    return _finish(launched["world4"])


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
    dims = dict(embed_dim=32, num_heads=4, num_classes=10)
    kw = {k: v for k, v in case["step_kw"].items() if k != "cga"}
    mu, nu = _nest(setup["mu"]), _nest(setup["nu"])
    if name == "float":
        # the float student, JAX's float DeiT
        params = dict(setup["float_weights"])
        mu, nu = _nest(setup["float_mu"]), _nest(setup["float_nu"])
        jm = jax_deit_model(tw.NAME, **dims, **conf)
    else:
        params = dict(single["start"]["calibrated"])
        pol = _jax_policy(cga)
        if name == "rprelu":
            # the RPReLUs' shifts and slopes, their moments zero
            params.update(setup["rprelu"])
            mu, nu = (_nest(dict(m, **{k: torch.zeros_like(v) for k, v in
                                       setup["rprelu"].items()}))
                      for m in (setup["mu"], setup["nu"]))
            pol = dataclasses.replace(pol, act_layer="rprelu")
        jm = jax_deit_model(tw.NAME, pol, **dims, **conf)
    variables = {k: v for k, v in _variables(params).items() if v}
    sched = (jschedule.constant_lr(tcga.LR) if cga else
             jschedule.cosine_with_warmup_cooldown(5e-3, **LR))
    with x64_jit():
        tx = jax_make_optimizer(sched, weight_decay=0.05)
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        step = jax.jit(jax_make_train_step(
            jm, tx, teacher=jax_deit_model(tw.NAME, **dims,
                                           **case.get("teacher_conf", {})),
            cga=CGA if cga else None,
            **{"loss_kind": "kd_soft_hard", **kw}))
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
            masks = jax.jit(lambda p: jcga.freeze_masks(
                p, bits=2, boundary_range=0.005, qk_reparam=True))(
                    jax.tree.map(jnp.asarray, variables["params"]))
            out["masks"] = {k: np.asarray(v) for k, v in
                            _flat(masks).items() if v.dtype != object}
        if name == "composed":
            logits, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
                jax.tree.map(jnp.asarray, variables),
                jnp.asarray(setup["batch"]["image"]))
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
                           ("pallas", dict(matmul_impl="pallas")),
                           ("telemetry", GRAMS), ("float", {}),
                           ("rprelu", {})):
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
# a step of two (the options cases): the second step starts from
# parameters the first left FP32_SUMS apart, so the losses agree to this
MULTI_STEP_LOSS = 1e-9


def _loss_limit(case, key=None):
    cases = CASES if key is None else _config_cases(key)
    return MULTI_STEP_LOSS if cases[case].get("steps", 1) > 1 else 1e-12


def _limit(case, name):
    if CASES.get(case, {}).get("steps", 1) > 1:
        # a second step from parameters the first left FP32_SUMS apart
        return FP32_SUMS
    if name.endswith(".s") or ".move" in name or "_move" in name:
        return FP32_SUMS
    return FP32_SUMS if case in FP32_PRODUCT_CASES else SAME


@pytest.mark.parametrize("case", FP64_CASES)
def test_step_is_the_single_process_step(ranks, single, case):
    """Every parameter, gradient and moment after the step (gathered)
    against the single process's on the global batch; the loss to 1e-12
    and the gradient norm (of the full gradients) to 1e-9, or with the
    fp32 products of fused and pallas 1e-6 (measured 2.8e-8: 90 % of it
    is the head's weight-LSQ scale gradient, a sum that cancels); the
    configurations of NEW_CASES, as the other students' steps
    (`test_config_step_is_the_single_process_step`), to FP32_SUMS: the
    norm sums the fp32-summed leaves' squares too (measured 1.25e-9, the
    BN student at world 4)."""
    want = single["cases"][case]
    fp32 = case in FP32_PRODUCT_CASES
    norm_limit = (1e-6 if fp32 else FP32_SUMS if case in NEW_CASES
                  else 1e-9)
    for r in ranks:
        got = r[case]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= (
            _loss_limit(case) * abs(want["metrics"]["loss"]))
        assert abs(got["metrics"]["grad_norm"]
                   - want["metrics"]["grad_norm"]) <= (
            norm_limit * want["metrics"]["grad_norm"])
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


@pytest.mark.parametrize("case", ["composed", "fused", "pallas", "cga",
                                  "telemetry", "float", "rprelu"])
def test_step_matches_jax(world2, world4, jax_refs, case):
    """The step at world 2 and 4 against JAX's single-device jitted step
    (x64): the loss (1e-9) and gradient norm (1e-6: the fp32-summed LSQ
    scale gradients), every updated parameter and every gradient leaf;
    `telemetry`'s loss holds the q, k and v Grams' direction matching
    over the cut heads (and at world 4 over the data axis) and the
    dampening term; the float student (its `qkv`, `proj`, `fc1` and `fc2`
    Dense cut) and the rprelu MLPs (their shifts and slopes cut with
    fc1's columns) against JAX's float and rprelu steps."""
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
            d = (got["params"][k].float() - w.float()).abs().numpy()
            assert d.max() <= 2.1 * lr, k
            assert np.mean(d > lr / 4) <= 0.2, k
            far, n = far + int(np.sum(d > lr / 4)), n + d.size
        assert far <= 0.1 * n


@pytest.mark.parametrize("case", FP64_CASES + BF16_CASES + FP32_CASES)
def test_replicated_gradients_bit_equal_across_model_ranks(ranks, case):
    """Every gradient a rank holds whole (the parameters that stay whole)
    leaves the backward with the same bits on every rank of its model
    group; the gathered gradients and parameters are the same on every
    rank.  The W2A2 student's cuts are `block_cuts`'; each case's are its
    layout's (the float student's `qkv`, an RPReLU's shifts and slopes)."""
    sliced = set(tensor.block_cuts("blocks_0", 32, 4, 18, 128, MP)) | set(
        tensor.block_cuts("blocks_1", 32, 4, 18, 128, MP))
    for r in ranks:
        assert set(r[case]["cuts"]) <= sliced or case in OTHER_CUTS
        mates = [q for q in ranks if q["mesh"][0] == r["mesh"][0]]
        a = r[case]["own_grads"]
        whole = [k for k in a if k not in r[case]["cuts"]]
        assert len(whole) > (15 if case == "float" else 30)
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


REMAT_STUDENTS = [None, "swin_qkr"]


@pytest.mark.parametrize("key", REMAT_STUDENTS, ids=["deit", "swin_qkr"])
def test_remat_step_is_the_step_without_it(ranks, key):
    """Block remat at TP with dropout on (DeiT's `remat`, Swin's
    `remat_stages`): the replay reissues the model group's collectives and
    draws the forward's masks, cut, from the restored generator, so every
    rank's loss, gradients and updated parameters are bit for bit those
    of the same TP step without remat (`dropout`, seeded alike); the
    forward draws that step's masks, and each block's replay draws its
    block's again."""
    for r in ranks:
        r = r if key is None else r["configs"][key]
        got, want = r["remat"], r["dropout"]
        assert got["metrics"]["loss"] == want["metrics"]["loss"]
        n = len(want["drawn"])
        assert n < len(got["drawn"]) <= 2 * n
        for (a, _), (b, _) in zip(got["drawn"], want["drawn"]):
            assert torch.equal(a, b)
        for a, _ in got["drawn"][n:]:
            assert any(torch.equal(a, b) for b, _ in want["drawn"])
        for what in ("own_grads", "params"):
            assert set(got[what]) == set(want[what])
            for k, v in want[what].items():
                assert torch.equal(got[what][k], v), (what, k)


@pytest.mark.parametrize("key", REMAT_STUDENTS, ids=["deit", "swin_qkr"])
def test_batchnorm_statistics(ranks, single, key):
    """The LN->BN swap at TP: the norms stay whole and reduce over the data
    group only, so after the step every running statistic is bit-equal
    across the model ranks, within SAME of one process's on the global
    batch and moved from its start; the checkpoint a rank writes holds
    them under one process's names (JAX's `batch_stats` paths), with the
    rank's values."""
    want = (single if key is None else single["configs"][key])["cases"][
        "batchnorm"]["buffers"]
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    assert len(stats) >= 8
    rs = [r if key is None else r["configs"][key] for r in ranks]
    for r in rs:
        got = r["batchnorm"]
        assert set(got["buffers"]) == set(want)
        assert set(got["buffers_file"]) == set(want)
        for k in stats:
            assert _rel_l2(got["buffers"][k], want[k]) <= SAME, k
            assert torch.equal(got["buffers_file"][k], got["buffers"][k]), k
            mates = [q for q in rs if q["mesh"][0] == r["mesh"][0]]
            for q in mates:
                assert torch.equal(q["batchnorm"]["buffers"][k],
                                   got["buffers"][k]), k
        moved = [k for k in stats if k.endswith(".mean")
                 and bool(got["buffers"][k].abs().max() > 0)]
        assert len(moved) == len(stats) // 2


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


# ------------------------------------------------ the other students
def _jax_config_run(single, key):
    """JAX's single-device jitted composed step (x64) of config `key` from
    its calibrated start: metrics, parameters, gradients; the eval logits
    and CGA's masks of the start."""
    c, res = CONFIGS[key], single["configs"][key]
    setup = res["setup"]
    variables = _variables(res["start"]["calibrated"])
    if c["family"] == "swin":
        jpol = policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=c["qkr"],
                                qk_reparam_type=0,
                                qmodules=default_swin_qmodules(SWIN_DEPTHS))
        jm = jswin.swin_model(c["name"], jpol, **c["dims"])
        jt = jswin.swin_model(c["name"], **c["dims"])
    else:
        jpol = policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=c["qkr"],
                                qmodules=default_deit_qmodules(DEPTH),
                                **_lsq_flags(c))
        jm = jax_deit_model(c["name"], jpol, **c["dims"])
        jt = jax_deit_model(c["name"], **c["dims"])
    mu, nu = _nest(setup["mu"]), _nest(setup["nu"])
    with x64_jit():
        tx = jax_make_optimizer(
            jschedule.cosine_with_warmup_cooldown(5e-3, **LR),
            weight_decay=0.05)
        jst = _jax_state(tx, variables, mu, nu, np.float64)
        step = jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                           loss_kind="kd_soft_hard"))
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
        logits, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            jax.tree.map(jnp.asarray, variables),
            jnp.asarray(setup["batch"]["image"]))
        out["logits"] = np.asarray(logits)
        if "cga" in c["cases"]:
            masks = jax.jit(lambda p: jcga.freeze_masks(
                p, bits=2, boundary_range=0.005, qk_reparam=c["qkr"],
                model_type=c["family"]))(
                    jax.tree.map(jnp.asarray, variables["params"]))
            out["masks"] = {k: np.asarray(v) for k, v in
                            _flat(masks).items() if v.dtype != object}
    return out


@pytest.fixture(scope="module")
def config_jax(single):
    return {k: _jax_config_run(single, k) for k in CONFIGS}


def _config_layout(key, single):
    """The layout `shard_model` gives config `key` at 2 model ranks (a
    mesh without a process group: the cuts only)."""
    m = tw._model(single["configs"][key]["setup"], {})
    return parallel.shard_model(m, _fake_mesh())


def _config(ranks, key):
    return [r["configs"][key] for r in ranks]


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_config_layout(single, key):
    """Which halves of each block are cut at 2 model ranks (a 3-head
    attention stays whole, its MLP is cut; Swin's patch mergings whole),
    and every cut reassembled in model order is the full tensor (the
    q, k and v column blocks of `qkv` among them)."""
    layout = _config_layout(key, single)
    full = single["configs"][key]["start"]["calibrated"]
    c = CONFIGS[key]
    heads = (c["dims"]["num_heads"] if c["family"] == "swin"
             else (c["dims"]["num_heads"],))
    m = tw._model(single["configs"][key]["setup"], {})
    for name in m.block_names:
        blk = getattr(m, name)
        if not hasattr(blk, "attn"):
            assert not any(n.startswith(name + ".") for n in layout.cuts)
            continue
        attn_cut = f"{name}.attn.proj.kernel" in layout.cuts
        assert attn_cut == (blk.attn.num_heads % MP == 0), name
        assert f"{name}.mlp.fc1.kernel" in layout.cuts
        if c["family"] == "swin":
            assert (f"{name}.attn.relative_position_bias_table"
                    in layout.cuts) == attn_cut
        if not c["qkr"]:
            assert (f"{name}.attn.qkv.kernel" in layout.cuts) == attn_cut
    assert any(h % MP for h in heads) == (key in ("swin_qkr", "swin",
                                                  "deit_t"))
    for n, cut in layout.cuts.items():
        parts = [cut.local(full[n], i) for i in range(MP)]
        back = torch.cat([q.reshape(cut.local_view) for q in parts],
                         dim=cut.axis).reshape(cut.shape)
        assert torch.equal(back, full[n]), n
    if key == "deit_no_qkr":
        # rank 1's q, k and v columns of qkv: heads 2 and 3 of each third
        w = full["blocks_0.attn.qkv.kernel"]
        d = 32 // 4
        want = torch.cat([w[:, t * 32 + 2 * d:t * 32 + 4 * d]
                          for t in range(3)], dim=1)
        assert torch.equal(layout.cuts["blocks_0.attn.qkv.kernel"].local(
            w, 1), want)


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_config_eval_logits(ranks, single, config_jax, key):
    """Calibration before sharding is the single process's bit for bit;
    the sharded eval forward on each data index's rows gives the single
    process's logits (SAME) and JAX's (1e-9), alike on the model ranks."""
    want_cal = single["configs"][key]["start"]["calibrated"]
    rs = _config(ranks, key)
    for r in rs:
        for k, v in want_cal.items():
            assert torch.equal(r["calibrated"][k], v), k
    got = torch.cat([r["logits"] for r in rs[::MP]])
    assert _rel_l2(got, single["configs"][key]["start"]["logits"]) <= SAME
    for r in rs:
        assert torch.equal(r["logits"], rs[r["mesh"][0] * MP]["logits"])
    np.testing.assert_allclose(got.numpy(), config_jax[key]["logits"],
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("key,case", CONFIG_FP64)
def test_config_step_is_the_single_process_step(ranks, single, key, case):
    """`test_step_is_the_single_process_step` for the other students; the
    gradient norm, which sums the fp32-summed leaves' squares too, to
    FP32_SUMS (measured 2.2e-9 at world 4, Swin with QKR, CGA)."""
    want = single["configs"][key]["cases"][case]
    for r in _config(ranks, key):
        got = r[case]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) <= (
            _loss_limit(case, key) * abs(want["metrics"]["loss"]))
        assert abs(got["metrics"]["grad_norm"]
                   - want["metrics"]["grad_norm"]) <= (
            FP32_SUMS * want["metrics"]["grad_norm"])
        for key_ in ("params", "mu", "nu"):
            assert set(got[key_]) == set(want[key_])
            for k, w in want[key_].items():
                assert got[key_][k].shape == w.shape, (key_, k)
                err = _rel_l2(got[key_][k], w)
                lim = (_limit(case, k) if key_ == "params"
                       else 10 * FP32_SUMS)
                assert err <= lim, (key_, k, err)
        for k, w in want["grads"].items():
            if k.endswith(".s"):
                assert _rel_l2(got["grads"][k], w) <= SCALE_GRAD, k


@pytest.mark.parametrize("key,case", CONFIG_BF16)
def test_config_bf16_step(ranks, single, key, case):
    """`test_bf16_step`'s rule for the Swin pallas bf16 step (K4's plain
    version; the replicated stage-0 attention, the cut stage 1)."""
    want = single["configs"][key]["cases"][case]
    from ofq_tpu_torch.train import cosine_with_warmup_cooldown
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    for r in _config(ranks, key):
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


@pytest.mark.parametrize("key,case", CONFIG_JAX)
def test_config_step_matches_jax(world2, world4, config_jax, key, case):
    """`test_step_matches_jax` for the other students: the composed step
    (and the fused one, at its fp32 limits) at world 2 and 4 against
    JAX's single-device jitted composed step under x64.  Swin's shifts
    sum their fp32 gradients over the 4-D map's rows, 8 x 64 at stage 0
    against DeiT's 8 x 18, so their gradients are held at
    FP32_PRODUCT_GRADS of the largest entry (the single process's own
    Swin step reads 1.0e-7 against JAX at `features_1_0.attn.
    quant_x_move_aft.bias`)."""
    shift_grads = (FP32_PRODUCT_GRADS if CONFIGS[key]["family"] == "swin"
                   else FP32_SUM_GRADS)
    ref = config_jax[key]
    fp32 = case == "fused"
    for ranks in (world2["steps"], world4["steps"]):
        got = ranks[0]["configs"][key][case]
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
                               shift_grads if _fp32_summed(k)
                               else JAX_GRAD), (k, err)


@pytest.mark.parametrize("key,case", CONFIG_FP64 + CONFIG_BF16 + [
    (k, "int8") for k in CONFIG_INT8])
def test_config_replicated_gradients_bit_equal(ranks, single, key, case):
    """Every gradient a rank holds whole (the replicated 3-head
    attentions, the patch mergings, norms, embeddings and head among
    them) has the same bits on every rank of its model group; so have
    the gathered gradients and parameters."""
    sliced = set(_config_layout(key, single).cuts)
    rs = _config(ranks, key)
    for r in rs:
        assert set(r[case]["cuts"]) == sliced or case in OTHER_CUTS
        mates = [q for q in rs if q["mesh"][0] == r["mesh"][0]]
        a = r[case]["own_grads"]
        whole = [k for k in a if k not in r[case]["cuts"]]
        assert len(whole) > 20
        for q in mates:
            for k in whole:
                assert torch.equal(a[k], q[case]["own_grads"][k]), k
            for key_ in ("grads", "params"):
                for k, v in r[case][key_].items():
                    assert torch.equal(v, q[case][key_][k]), (key_, k)


@pytest.mark.parametrize("fault", tw.FAULTS)
def test_window_softmax_scale_faults_are_caught(ranks, single, fault):
    """Faults in the backward of the cut window attentions' softmax scales
    (`tp_worker.FAULTS`), planted in the composed fp64 step of the QKR
    Swin student: each cut block's `quan_softmax.s` gradient leaves
    SCALE_GRAD of the single process's, which
    `test_config_step_is_the_single_process_step` holds it to.  ds left
    unreduced also breaks the ranks' bit-equality; the grad-scale factor
    at the local heads keeps it (the same wrong gradient on every rank),
    so only the comparison with one process sees that one."""
    want = single["configs"]["swin_qkr"]["cases"]["composed"]["grads"]
    scales = [k for k in want if k.endswith("attn.quan_softmax.s")]
    # stage 1's blocks (`features_3_*`, 4 heads) are cut, stage 0's whole
    cut = [k for k in scales if k.startswith("features_3")]
    assert len(cut) == SWIN_DEPTHS[1] and len(scales) == sum(SWIN_DEPTHS)
    rs = _config(ranks, "swin_qkr")
    for r in rs:
        got = r[fault]["grads"]
        for k in scales:
            err = _rel_l2(got[k], want[k])
            assert (err > SCALE_GRAD) == (k in cut), (k, err)
        mates = [q for q in rs if q["mesh"][0] == r["mesh"][0]]
        same = all(torch.equal(r[fault]["own_grads"][k],
                               q[fault]["own_grads"][k])
                   for q in mates for k in cut)
        assert same == (fault == "softmax_grad_scale_local_heads")


@pytest.mark.parametrize("key", CONFIG_DROPOUT)
def test_config_dropout_masks_are_the_global_draw_cut(ranks, single, key):
    """The window attentions' and MLPs' masks: the single process's, its
    rows, cut to this rank's heads or columns where the tensor is cut
    (stage 1), whole where it is not (stage 0's 3-head attention)."""
    want = single["configs"][key]["cases"]["dropout"]["drawn"]
    for r in _config(ranks, key):
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


@pytest.mark.parametrize("key", sorted(k for k, v in CONFIGS.items()
                                 if "cga" in v["cases"]))
def test_config_cga_masks(ranks, single, config_jax, key):
    """CGA's masks on the slices, gathered: the single process's and
    JAX's (with QKR Swin's reductions, whole, among them); the step's
    parameters against the single process's in
    `test_config_step_is_the_single_process_step`."""
    want = single["configs"][key]["cases"]["cga"]["masks"]
    jmasks = config_jax[key]["masks"]
    assert set(want) == set(jmasks)
    if CONFIGS[key]["family"] == "swin" and CONFIGS[key]["qkr"]:
        assert any(k.endswith("reduction.kernel") for k in want)
    for r in _config(ranks, key):
        got = r["cga"]["masks"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert torch.equal(got[k], w), k
            np.testing.assert_array_equal(got[k].numpy(), jmasks[k])
    share = np.mean([(m == 0).float().mean().item() for m in want.values()])
    assert 0 < share < 0.2


@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_config_checkpoints_round_trip(ranks, single, key):
    """`test_checkpoints_round_trip` for the other students: the sharded
    start's file is one process's bit for bit, the file after the step
    restores at mp 1 as the gathered state, one process's file restores
    into the shards as their cut."""
    res = single["configs"][key]
    setup, ref = res["setup"], res["payload"]
    rs = _config(ranks, key)
    for r in rs:
        assert r["checkpoints"]["round_trip"]
    c0 = rs[0]["checkpoints"]
    _same_tree(checkpoint.load(checkpoint.make_manager(c0["start_dir"]), 0),
               ref)
    payload = checkpoint.load(checkpoint.make_manager(c0["dir"]), 0)
    m = tw._model(setup, {})
    st = TrainState.create(m, make_optimizer(lambda c: 1e-3))
    checkpoint.restore_into(payload, st, m)
    for k, v in rs[0]["composed"]["params"].items():
        assert torch.equal(st.params[k], v), k
    cuts = _config_layout(key, single).cuts
    for r in rs:
        got = r["checkpoints"]["from_single"]
        for key_, full in (("params", ref["params"]),
                           ("mu", ref["opt_state"]["mu"])):
            for k, v in full.items():
                c = cuts.get(k)
                want = v if c is None else c.local(v, r["mesh"][1])
                assert torch.equal(got[key_][k],
                                   want.to(got[key_][k].dtype)), k


def test_runner_world2_with_the_steps_options(world2):
    """`cli.train.main` at `--mesh-model-parallel 2` with `--matmul-impl
    int8`, kd_qkv (`--kd_hard_and_soft 3`), `--model-ema`, AGC,
    `--master-dtype bfloat16`, `--track-oscillation`, `--wandb-watch` and
    the dampening loss, and with `--wq-mode lsq` and value clipping: both
    ranks report the same; rank 0's checkpoint holds one process's names
    with bf16 masters, the EMA and the hook's states."""
    r0, r1 = (r["option_fits"] for r in world2["runner"])
    assert set(r0) == {"int8_options", "lsq"}
    for k in r0:
        assert r0[k] == r1[k], k
    payload = checkpoint.load(checkpoint.make_manager(
        os.path.join(world2["out"], "opt")), 0)
    assert {v.dtype for v in payload["params"].values()} == {torch.bfloat16}
    assert set(payload["ema_params"]) == set(payload["params"])
    assert payload["oscillation"] and all(
        payload["oscillation"][n]["prev_x_int"].shape
        == payload["params"][n].shape for n in payload["oscillation"])
    plain = checkpoint.load(checkpoint.make_manager(
        os.path.join(world2["out"], "tp")), 0)["params"]
    assert {k: v.shape for k, v in payload["params"].items()} == {
        k: v.shape for k, v in plain.items()}


def test_swin_cli_world2_trains_finetunes_and_evaluates(world2):
    """`cli.train`, `cli.cga` and `cli.eval` on the Swin student at
    `--mesh-model-parallel 2` (pallas, K4's plain version): rank 0 writes
    both experiments, the ranks report the same, and the eval of the CGA
    checkpoint at mp 2 gives one process's top-1, top-5 and loss."""
    r0, r1 = (r["swin"] for r in world2["runner"])
    for exp in ("p1", "cga"):
        assert sorted(os.listdir(os.path.join(world2["swin_out"], exp))) == [
            "0", "args.yaml", "summary.csv"]
    for what in ("train", "cga"):
        assert r0[what] == r1[what]
    single = world2["swin_single_eval"]
    for got in (r0["eval"], r1["eval"]):
        assert (got["top1"], got["top5"]) == (single["top1"],
                                              single["top5"])
        assert abs(got["loss"] - single["loss"]) <= 1e-5 * abs(
            single["loss"])


# ------------------------------------------------------------ the int8 core
# the int8 step in fp32 against the single process: the forward is the
# single process's bit for bit (int32 sums exact, the epilogue once, a
# column's codes its own), the backward sums the column-parallel inputs'
# cotangents and the row-parallel input scales' `ds` over the group in
# another order: each parameter after the step within FP32_SUMS (rel L2),
# the moments within 10 FP32_SUMS, the LSQ scales' gradients within
# SCALE_GRAD, the loss exact and the gradient norm within 1e-6
INT8_NORM = 1e-6
# the LSQ scales' gradients in fp32 (sums of B N C terms that cancel;
# measured 1.8e-5 at `patch_embed.input_quant.s`)
INT8_SCALE_GRAD = 1e-4


def _jax_int8_run(res, c):
    """JAX's single-device jitted int8 step in fp32 (its int8 VJP cannot
    run under x64) from a setup's calibrated start: metrics, parameters."""
    setup = res["setup"]
    variables = jax.tree.map(lambda a: a.astype(np.float32),
                             _variables(res["start"]["calibrated"]))
    if c["family"] == "swin":
        jpol = policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=c["qkr"],
                                qk_reparam_type=0,
                                qmodules=default_swin_qmodules(SWIN_DEPTHS))
        jm = jswin.swin_model(c["name"], jpol, matmul_impl="int8",
                              **c["dims"])
        jt = jswin.swin_model(c["name"], **c["dims"])
    else:
        jpol = policy_from_args(wq_bitw=2, aq_bitw=2, qk_reparam=c["qkr"],
                                qmodules=default_deit_qmodules(DEPTH))
        jm = jax_deit_model(c["name"], jpol, matmul_impl="int8",
                            **c["dims"])
        jt = jax_deit_model(c["name"], **c["dims"])
    f32 = np.float32
    tx = jax_make_optimizer(
        jschedule.cosine_with_warmup_cooldown(5e-3, **LR), weight_decay=0.05)
    jst = _jax_state(tx, variables, _nest(setup["mu"], f32),
                     _nest(setup["nu"], f32), f32)
    step = jax.jit(jax_make_train_step(jm, tx, teacher=jt,
                                       loss_kind="kd_soft_hard"))
    new, met = step(jst, {"image": jnp.asarray(setup["batch"]["image"], f32),
                          "label": jnp.asarray(setup["batch"]["label"])},
                    jax.random.key(0),
                    jax.tree.map(jnp.asarray, _nest(setup["teacher"], f32)))
    return dict(metrics={k: float(v) for k, v in met.items()},
                params=_flat(jax.tree.map(np.asarray, new.params["params"])))


INT8_STUDENTS = ["deit"] + CONFIG_INT8


@pytest.fixture(scope="module")
def int8_jax(single):
    out = {"deit": _jax_int8_run(single, dict(name=tw.NAME, dims=tw.DIMS,
                                              family="deit", qkr=True))}
    for k in CONFIG_INT8:
        out[k] = _jax_int8_run(single["configs"][k], CONFIGS[k])
    return out


def _int8_of(ranks, single, student):
    if student == "deit":
        return [r["int8"] for r in ranks], single["cases"]["int8"]
    return ([r["configs"][student]["int8"] for r in ranks],
            single["configs"][student]["cases"]["int8"])


@pytest.mark.parametrize("student", INT8_STUDENTS)
def test_int8_eval_logits_bit_equal(ranks, single, student):
    """The sharded int8 eval forward on each data index's rows: the single
    process's logits bit for bit, alike on the model ranks."""
    got, want = _int8_of(ranks, single, student)
    assert torch.equal(torch.cat([r["logits"] for r in got[::MP]]),
                       want["logits"])
    for i, r in enumerate(got):
        assert torch.equal(r["logits"], got[i - i % MP]["logits"])


@pytest.mark.parametrize("student", INT8_STUDENTS)
def test_int8_step_is_the_single_process_step(ranks, single, student):
    """The int8 fp32 step against the single process's (INT8_NORM and the
    limits above)."""
    got, want = _int8_of(ranks, single, student)
    for r in got:
        assert r["metrics"]["loss"] == want["metrics"]["loss"]
        assert abs(r["metrics"]["grad_norm"] - want["metrics"]["grad_norm"]
                   ) <= INT8_NORM * want["metrics"]["grad_norm"]
        for key, lim in (("params", FP32_SUMS), ("mu", 10 * FP32_SUMS),
                         ("nu", 10 * FP32_SUMS)):
            assert set(r[key]) == set(want[key])
            for k, w in want[key].items():
                assert _rel_l2(r[key][k], w) <= lim, (key, k)
        for k, w in want["grads"].items():
            if k.endswith(".s"):
                assert _rel_l2(r["grads"][k], w) <= INT8_SCALE_GRAD, k


@pytest.mark.parametrize("student", INT8_STUDENTS)
def test_int8_step_matches_jax(ranks, single, int8_jax, student):
    """The int8 fp32 step against JAX's jitted int8 step under
    `test_torch_int8_slice.test_step_fp32`'s rule: the loss and gradient
    norm to 1e-5 relative, no parameter farther than 2.1 lr, at most 1 %
    of a leaf's elements farther than 1e-3 lr + 1e-6 |p|."""
    from ofq_tpu_torch.train import cosine_with_warmup_cooldown
    lr = cosine_with_warmup_cooldown(5e-3, **LR)(START)
    ref = int8_jax[student]
    got, _ = _int8_of(ranks, single, student)
    for r in got:
        for k in ("loss", "grad_norm"):
            assert abs(r["metrics"][k] - ref["metrics"][k]) <= (
                1e-5 * abs(ref["metrics"][k])), k
        assert set(r["params"]) == set(ref["params"])
        for k, w in ref["params"].items():
            d = np.abs(r["params"][k].numpy() - w)
            assert d.max() <= 2.1 * lr, k
            assert np.mean(d > 1e-3 * lr + 1e-6 * np.abs(w)) <= 0.01, k


# -------------------------------------------------------- the options
def _options_of(ranks, single, student, case):
    if student == "deit":
        return [r[case] for r in ranks], single["cases"][case]
    return ([r["configs"][student][case] for r in ranks],
            single["configs"][student]["cases"][case])


def _leaf(a, b, k):
    """The fp64 options steps' per-leaf limit (`_limit`'s)."""
    return _rel_l2(a, b) <= _limit("composed", k)


# the clipped gradients against the single process's, as
# `test_step_matches_jax` holds gradients: the largest difference of a
# leaf over the step's largest entry, FP32_SUM_GRADS (some leaves'
# gradients are fp32 noise: `move_qkx_aft.bias`); with bf16 masters the
# gradients are rounded to bf16 before the clipping, and a partial sum in
# another order moves an element by one bf16 ulp: BF16_GRADS
BF16_GRADS = 2.0 ** -8


def _check_ema(got, want, case):
    assert got["ema"] is not None and set(got["ema"]) == set(want["ema"])
    for k, w in want["ema"].items():
        assert got["ema"][k].dtype == torch.float32
        assert _leaf(got["ema"][k], w, k), k
    # the EMA moved from the start (decay 0.9 over two steps)
    assert any(not torch.equal(got["ema"][k], got["params"][k].float())
               for k in want["ema"])


def _check_clipped(got, want, case):
    assert set(got["clipped"]) == set(want["clipped"])
    top = max(float(w.abs().max()) for w in want["clipped"].values())
    lim = BF16_GRADS if case in BF16_CASES else FP32_SUM_GRADS
    moved = 0
    for k, w in want["clipped"].items():
        d = float((got["clipped"][k].double() - w.double()).abs().max())
        assert d <= lim * top, (k, d / top)
        moved += int(not torch.equal(want["clipped"][k], want["grads"][k]))
    assert moved > 0          # the clipping acted


def _check_norms(got, want, case):
    names = [k for k in want["metrics"] if k.startswith("grad_norm/")]
    assert len(names) > 4 and set(names) <= set(got["metrics"])
    for k in names:
        assert abs(got["metrics"][k] - want["metrics"][k]) <= (
            FP32_SUMS * want["metrics"][k]), k


def _check_oscillation(got, want, case):
    assert set(got["osc"]) == set(want["osc"]) and len(want["osc"]) >= 4
    for n, st in want["osc"].items():
        for f, w in st.items():
            g = got["osc"][n][f]
            assert g.shape == w.shape and g.dtype == w.dtype, (n, f)
            if w.is_floating_point():
                assert torch.allclose(g, w, rtol=1e-12, atol=1e-12), (n, f)
            else:
                assert torch.equal(g, w), (n, f)
    k = "oscillation/ema_mean"
    assert abs(got["metrics"][k] - want["metrics"][k]) <= 1e-12
    # the states tracked both steps
    assert all(int(st["iters"]) == 2 for st in got["osc"].values())


def _check_loss(got, want, case):
    for i, (g, w) in enumerate(zip(got["history"], want["history"])):
        lim = 1e-12 if i == 0 else MULTI_STEP_LOSS
        assert abs(g["loss"] - w["loss"]) <= lim * abs(w["loss"])


def _check_masters(got, want, case):
    for k, w in want["params"].items():
        assert got["params"][k].dtype == w.dtype == torch.bfloat16, k


# (student, case, what): each option's leaves against the single process
OPTION_LEAVES = [
    ("deit", "options", "ema"), ("deit", "options", "clip_agc"),
    ("deit", "options", "grad_norms"), ("deit", "options", "oscillation"),
    ("deit", "options", "kd_qk_dampening"),
    ("deit", "options_norm", "ema"), ("deit", "options_norm", "clip_norm"),
    ("deit", "options_norm", "grad_norms"),
    ("deit", "options_norm", "kd_token"),
    ("deit", "telemetry", "kd_qkv_dampening"),
    ("deit", "options_bf16", "masters"),
    ("deit", "options_bf16", "clip_value"),
    ("swin_qkr", "options", "ema"), ("swin_qkr", "options", "clip_agc"),
    ("swin_qkr", "options", "grad_norms"),
    ("swin_qkr", "options", "oscillation"),
    ("swin_qkr", "options", "dampening"),
    ("deit_t", "options", "oscillation"),
    ("deit_t", "options", "kd_qk_dampening"),
]
_OPTION_CHECKS = {"ema": _check_ema, "grad_norms": _check_norms,
                  "oscillation": _check_oscillation, "masters": _check_masters,
                  "kd_qk_dampening": _check_loss, "kd_token": _check_loss,
                  "kd_qkv_dampening": _check_loss, "dampening": _check_loss}


@pytest.mark.parametrize("student,case,what", OPTION_LEAVES)
def test_option_leaves_are_the_single_process(ranks, single, student, case,
                                              what):
    """Each option of a multi-option step (two steps but `telemetry`),
    against the single process's: the EMA (fp32, gathered), the clipped
    gradients (AGC, norm, value; some clipped), the per-layer gradient
    norms, the oscillation hook's states (gathered) and `ema_mean`, the
    loss of each step with the telemetry losses and the dampening term,
    the bf16 masters' dtype (their values: `test_bf16_step`)."""
    got, want = _options_of(ranks, single, student, case)
    check = _OPTION_CHECKS.get(what, _check_clipped)
    for r in got:
        check(r, want, case)


def test_option_faults_are_caught(ranks, single):
    """A row-parallel full-LSQ weight scale's grad-scale factor at its
    slice's shape moves `proj` and `fc2`'s `weight_quant.s` gradients
    beyond SCALE_GRAD (on every rank alike: the ranks' bit-equality cannot
    see it), the others stay; DeiT-T's dampening loss with its whole
    attention kernels counted once per rank moves the loss."""
    want = single["configs"]["deit_lsq"]["cases"]["composed"]["grads"]
    scales = [k for k in want if k.endswith("weight_quant.s")
              and "blocks_" in k]
    rows = [k for k in scales if ".proj." in k or ".fc2." in k]
    assert len(rows) == 2 * DEPTH and len(scales) == 4 * DEPTH
    rs = _config(ranks, "deit_lsq")
    for r in rs:
        got = r["lsq_weight_grad_scale_local"]
        for k in scales:
            assert (_rel_l2(got["grads"][k], want[k]) > SCALE_GRAD) == (
                k in rows), k
        for q in rs:
            if q["mesh"][0] == r["mesh"][0]:
                for k in rows:
                    assert torch.equal(
                        got["own_grads"][k],
                        q["lsq_weight_grad_scale_local"]["own_grads"][k])
    ref = single["configs"]["deit_t"]["cases"]["options"]["metrics"]
    for r in _config(ranks, "deit_t"):
        loss = r["dampening_whole_per_rank"]["metrics"]["loss"]
        assert abs(loss - ref["loss"]) > 1e-6 * abs(ref["loss"])


# ------------------------------------------------------------ refusals
def _fake_mesh(world=2, mp=MP):
    return Mesh(world=world, rank=0, local_rank=0,
                device=torch.device("cpu"), model_parallel=mp)


def _small(policy=None, **conf):
    return create_model(tw.NAME, policy=policy or w2a2_qkr_policy(DEPTH),
                        device="cpu", **{**tw.DIMS, **conf})


def _swin(policy=None, **conf):
    return create_model(tw.SWIN, policy=policy or w2a2_qkr_swin_policy(
        SWIN_DEPTHS), device="cpu", **{**tw.SWIN_DIMS, **conf})


# a frozen artifact: the JAX package serves and freezes on one device
REFUSED_MODELS = {
    "frozen": lambda: _small(dataclasses.replace(
        w2a2_qkr_policy(DEPTH), weight_frozen=True)),
    "swin_frozen": lambda: _swin(dataclasses.replace(
        w2a2_qkr_swin_policy(SWIN_DEPTHS), weight_frozen=True)),
}


@pytest.mark.parametrize("what", sorted(REFUSED_MODELS))
def test_unported_models_refuse(what):
    with pytest.raises(NotImplementedError, match="on one device"):
        parallel.shard_model(REFUSED_MODELS[what](), _fake_mesh())


# the configurations the earlier slices refused, each with the student
# and case of the launches that run it: (constructor, config key or None
# for the DeiT student, case)
SHARDED_MODELS = {
    "swin": (lambda: _swin(QuantPolicy()), "swin_qkr", "float"),
    "remat": (lambda: _small(remat=True), None, "remat"),
    "attn_remat": (lambda: _small(attn_impl="remat"), None, "attn_remat"),
    "batchnorm": (lambda: _small(**BN), None, "batchnorm"),
    "prelu": (lambda: _small(_qkr_policy(act_layer="prelu")), None,
              "prelu"),
    "float": (lambda: _small(QuantPolicy()), None, "float"),
    "swin_remat": (lambda: _swin(remat_stages=(0,)), "swin_qkr", "remat"),
    "swin_attn_remat": (lambda: _swin(attn_impl="remat"), "swin_qkr",
                        "attn_remat"),
    "swin_batchnorm": (lambda: _swin(**BN), "swin_qkr", "batchnorm"),
    "swin_prelu": (lambda: _swin(dataclasses.replace(
        w2a2_swin_policy(SWIN_DEPTHS, qk_reparam=False),
        act_layer="prelu")), "swin", "prelu"),
}


@pytest.mark.parametrize("what", sorted(SHARDED_MODELS))
def test_configurations_shard(what, ranks, single):
    """Each configuration the earlier slices refused shards at 2 model
    ranks: its layout (every cut a parameter of the model, reassembled in
    model order the full tensor, the rank's slice in its place; the cut
    attentions and MLPs told their roles, a PReLU its mesh), the same
    cuts as the launches' step of it, and the sharded eval forward on
    each data index's rows against the unsharded model's (SAME), alike on
    the model ranks."""
    from ofq_tpu_torch.nn.linear import PReLU
    make, key, case = SHARDED_MODELS[what]
    m = make()
    full = {n: p.detach().clone() for n, p in m.named_parameters()}
    layout = parallel.shard_model(m, _fake_mesh())
    params = dict(m.named_parameters())
    assert layout.cuts and set(layout.cuts) <= set(full)
    for n, c in layout.cuts.items():
        assert params[n].shape == c.local_shape, n
        assert torch.equal(params[n], c.local(full[n], 0)), n
        back = torch.cat([c.local(full[n], i).reshape(c.local_view)
                          for i in range(MP)], dim=c.axis)
        assert torch.equal(back.reshape(c.shape), full[n]), n
    for name, blk in tensor._blocks(m):
        cut_attn = f"{name}.attn.proj.kernel" in layout.cuts
        assert (blk.attn.tp is not None) == cut_attn, name
        assert (blk.attn.proj.tp is not None) == cut_attn, name
        assert blk.mlp.fc2.tp[0] == "row" and blk.mlp.tp is not None
        if isinstance(blk.mlp.act, PReLU):
            assert blk.mlp.act.tp is not None
    rs = [r if key is None else r["configs"][key] for r in ranks]
    want = (single if key is None else single["configs"][key])["cases"][
        case]["logits"]
    for r in rs:
        assert r[case]["cuts"] == sorted(layout.cuts)
        assert torch.equal(r[case]["logits"],
                           rs[r["mesh"][0] * MP][case]["logits"])
    got = torch.cat([r[case]["logits"] for r in rs[::MP]])
    assert _rel_l2(got, want) <= SAME


# the properties both families share: each configuration that turns one
# on, and the other family's counterpart
REFUSAL_PROPERTIES = {
    "deit": (_small, [dict(remat=True), dict(attn_impl="remat")],
             [dict(qqkkvv=True), dict(return_features=True)],
             lambda: w2a2_deit_policy(DEPTH, wq_mode="lsq"), True),
    "swin": (_swin, [dict(remat_stages=(0,)), dict(attn_impl="remat")],
             [dict(qqkkvv=True)],
             lambda: w2a2_swin_policy(SWIN_DEPTHS, wq_mode="lsq"), False),
}


@pytest.mark.parametrize("family", sorted(REFUSAL_PROPERTIES))
def test_refusals_read_properties_both_families_have(family):
    """Remat (the model's checkpointed blocks, `remat_names`, or every
    attention's `attn_impl`), `cfg.telemetry`, the model's `lsq_weights`
    and each attention's `weight_bits`: off on the W2A2 student, on where
    a configuration asks for it (Swin's linears are StatsQ ones whatever
    the policy's weight mode)."""
    from ofq_tpu_torch.nn.linear import LsqLinear

    def remats(m):
        return bool(m.remat_names) or all(
            blk.attn.attn_impl == "remat" for _, blk in tensor._blocks(m))

    make, remat_confs, telemetry, lsq_policy, lsq = REFUSAL_PROPERTIES[
        family]
    m = make()
    assert not remats(m) and not m.cfg.telemetry and not m.lsq_weights
    assert {blk.attn.weight_bits for _, blk in tensor._blocks(m)} == {2}
    for conf in remat_confs:
        assert remats(make(**conf)), conf
    for conf in telemetry:
        assert make(**conf).cfg.telemetry, conf
    m = make(lsq_policy())
    assert m.lsq_weights is lsq
    assert any(isinstance(mod, LsqLinear) for mod in m.modules()) is lsq
    assert {blk.attn.weight_bits for _, blk in tensor._blocks(m)} == {2}


def test_sharded_serving_and_bf16_state_refuse():
    """Serving a sharded model (the JAX package serves on one device) and
    sharding it twice raise; a bf16 state of a sharded model holds its
    slices' masters in bf16 and the layout."""
    m = _small()
    layout = parallel.shard_model(m, _fake_mesh())
    with pytest.raises(NotImplementedError, match="on one device"):
        Predictor(m, batch_size=2, img_size=32, device="cpu")
    st = TrainState.create(m, make_optimizer(lambda c: 1e-3),
                           master_dtype="bfloat16")
    assert st.tp is layout
    work = dict(m.named_parameters())
    for k, v in st.params.items():
        assert v.dtype == torch.bfloat16 and v.shape == work[k].shape, k
    with pytest.raises(ValueError, match="sharded already"):
        parallel.shard_model(m, _fake_mesh())


@pytest.mark.parametrize("world,mp,heads", [(2, 3, 4), (4, 4, 6), (2, 2, 3)])
def test_model_parallel_must_divide(world, mp, heads):
    """An mp that does not divide the world (make_mesh), or that divides
    neither a block's heads nor its MLP's hidden width (shard_model:
    mlp_ratio 1.125 gives 27 and 54 hidden units), raises ValueError."""
    if world % mp:
        with pytest.raises(ValueError, match="does not divide"):
            parallel.make_mesh(model_parallel=mp, device="cpu")
    else:
        m = _small(embed_dim=8 * heads, num_heads=heads, mlp_ratio=1.125)
        with pytest.raises(ValueError, match="does not divide"):
            parallel.shard_model(m, _fake_mesh(world, mp))
    assert common.parse_args(["synthetic", "--mesh-model-parallel",
                              str(mp)]).mesh_model_parallel == mp


@pytest.mark.parametrize("name,qkr,blocks,C", [
    ("swin_t", True, 2, 96), ("swin_t", False, 2, 96),
    ("deit_tiny_distilled_patch16_224", True, 12, 192)])
def test_whole_attention_bytes_a_rank_holds_beyond_jaxs(name, qkr, blocks,
                                                        C):
    """At 2 model ranks the attentions whose 3 heads stay whole (Swin-T's
    stage 0, every DeiT-T block) are the only leaves a rank holds whole
    that JAX's `param_spec` halves (the q, k, v kernels and v's bias, or
    `qkv`'s kernel and bias, and proj's kernel): fp32 bytes a rank holds
    beyond JAX's layout, (4 C^2 + C) * 4 / 2 a block with QKR, (4 C^2 +
    3 C) * 4 / 2 without."""
    pol = (w2a2_qkr_swin_policy() if name == "swin_t" and qkr else
           w2a2_swin_policy(qk_reparam=False) if name == "swin_t" else
           w2a2_qkr_policy(12))
    # the structure alone (no initializer: the cuts read shapes only)
    m = (swin_models.swin_model(name, pol) if name == "swin_t"
         else deit_models.deit_model(name, pol))
    shapes = {n: p.shape for n, p in m.named_parameters()}
    layout = parallel.shard_model(m, _fake_mesh())
    cut = {n.split(".")[0] for n in layout.cuts if ".attn." in n}
    extra = sum(math.prod(sh) * 4 // 2 for n, sh in shapes.items()
                if ".attn." in n and n.split(".")[0] not in cut
                and "model" in parallel.param_spec(n, sh))
    assert extra == blocks * (4 * C * C + (1 if qkr else 3) * C) * 4 // 2
    assert len({n.split(".")[0] for n in shapes if ".attn." in n}
               - cut) == blocks


@pytest.mark.parametrize("world,mp,heads,attention", [
    (2, 2, 3, False), (4, 4, 6, False), (4, 2, 6, True), (4, 4, 4, True)])
def test_model_parallel_that_divides_the_mlp_only(world, mp, heads,
                                                  attention):
    """Where mp divides the MLP's hidden width but not the heads, the
    block's attention stays whole (num_heads, no `tp`, proj not
    row-parallel) and its MLP is cut; where it divides both, both are."""
    m = _small(embed_dim=8 * heads, num_heads=heads)
    layout = parallel.shard_model(m, _fake_mesh(world, mp))
    for name in ("blocks_0", "blocks_1"):
        attn = getattr(m, name).attn
        assert (attn.tp is not None) == attention
        assert attn.num_heads == (heads // mp if attention else heads)
        assert (attn.proj.tp is not None) == attention
        assert (f"{name}.attn.q_kernel" in layout.cuts) == attention
        assert f"{name}.mlp.fc1.kernel" in layout.cuts
        assert getattr(m, name).mlp.fc2.tp[0] == "row"
