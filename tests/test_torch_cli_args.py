"""The port's CLI surface against `ofq_tpu.cli`: the parser and its YAML
stage, the policy, the experiment directory, the loss selection, the
model overrides; the step FLOP count; the synthetic stream and mixup's
mixing.  Pure host code: equal means equal (`vars()`, dataclass fields,
FLOPs bit for bit); mixup's mixing, given JAX's draws, within 1e-6."""

import dataclasses
import re
import shlex
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofq_tpu.cli import common as jcommon
from ofq_tpu.cli import runner as jrunner
from ofq_tpu.data import pipeline as jpipeline
from ofq_tpu.utils import flops as jflops
from ofq_tpu_torch.cli import common, runner
from ofq_tpu_torch.data import pipeline
from ofq_tpu_torch.utils import flops

REPO = Path(__file__).resolve().parents[1]


def _recipe_argvs(script: str) -> list[list[str]]:
    """The argv of each `python3 -m ofq_tpu.cli.*` command of a recipe."""
    text = (REPO / script).read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*python3 -m ofq_tpu\.cli\.\w+ (.*)", line)
        if m:
            argv = m.group(1).replace('"$DATA_DIR"', "synthetic")
            argv = argv.replace('"$FP_CKPT"', "fp.pth.tar")
            out.append(shlex.split(argv))
    return out


CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yml"))
RECIPES = [argv for s in ("train_scripts/deit_s/w2a2_deit_s.sh",
                          "train_scripts/swin_t/w2a2_swin_t.sh")
           for argv in _recipe_argvs(s)]
ARGVS = (
    [["-c", f"configs/{c}", "synthetic"] for c in CONFIGS] + RECIPES + [
        ["synthetic", "--boundaryRange", "0.01"],
        ["-c", "configs/deit_imagenet_qat.yml", "--boundaryRange", "0.02"],
        ["synthetic", "--world_size", "8", "--visible_gpu", "0,1",
         "--tcp_port", "1234", "--amp"],
        ["--model", "deit_test_distilled", "--img-size", "32",
         "--matmul-impl", "fused", "--attn-impl", "fused",
         "--compute-dtype", "bfloat16", "--master-dtype", "bfloat16",
         "--matmul-precision", "high", "--mesh-model-parallel", "1"],
    ])
IDS = ([f"config-{c}" for c in CONFIGS]
       + ["deit_s-train", "deit_s-cga", "swin_t-train", "swin_t-cga"]
       + ["boundaryRange", "yaml-boundaryRange", "gpu-flags", "extensions"])


def test_recipes_found():
    assert len(RECIPES) == 4


@pytest.fixture(scope="module")
def parsed(request):
    import os
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        return [(jcommon.parse_args(a), common.parse_args(a)) for a in ARGVS]
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("i", range(len(ARGVS)), ids=IDS)
def test_parse_args_equal(parsed, i):
    want, got = parsed[i]
    assert vars(got) == vars(want)


@pytest.mark.parametrize("i", range(len(ARGVS)), ids=IDS)
def test_policy_experiment_and_loss_equal(parsed, i):
    want, got = parsed[i]
    assert dataclasses.asdict(common.policy_from_namespace(got)) == \
        dataclasses.asdict(jcommon.policy_from_namespace(want))
    assert common.experiment_dir(got) == jcommon.experiment_dir(want)
    assert runner.select_loss_kind(got) == jrunner.select_loss_kind(want)


def test_parser_actions_equal():
    """Every flag, alias, default and choice; the help strings may
    differ."""
    def table(p):
        return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                       tuple(a.choices or ()), a.nargs, repr(a.type),
                       a.const) for a in p._actions)
    assert table(common.build_parser()) == table(jcommon.build_parser())


@pytest.mark.parametrize("extra", [
    [], ["--use-kd", "--kd_hard_and_soft", "2"],
    ["--use-token-kd", "--drop-path", "0.1"],
    ["--replace-ln-by-bn", "--matmul-impl", "pallas",
     "--compute-dtype", "bfloat16", "--attn-impl", "remat"],
    ["--matmul-impl", "fused", "--attn-impl", "fused"],
    ["--quant_teacher", "--use-kd"],
], ids=["plain", "kd_qk", "token", "bn-pallas-bf16", "fused", "qteacher"])
@pytest.mark.parametrize("family", ["deit", "swin"])
@pytest.mark.parametrize("teacher", [False, True], ids=["student",
                                                         "teacher"])
def test_build_model_config_fields(family, extra, teacher):
    """The student's (teacher's) model: same name, policy and config
    fields as the JAX runner's `build_model` gives the test models."""
    model = "deit_test_distilled" if family == "deit" else "swin_test"
    argv = ["synthetic", "--model", model, "--model_type", family,
            "--teacher", model, "--teacher_type", family, "--img-size", "32",
            "--wq-enable", "--aq-enable", "--wq-bitw", "2", "--aq-bitw", "2",
            "--qk_reparam"] + extra
    jargs, args = jcommon.parse_args(argv), common.parse_args(argv)
    jpol = jcommon.policy_from_namespace(jargs)
    pol = common.policy_from_namespace(args)
    jm = jrunner.build_model(jargs, jpol, teacher=teacher)
    name, ppol, over = runner.model_overrides(args, pol, teacher=teacher)
    assert name == (jargs.teacher if teacher else jargs.model)
    assert dataclasses.asdict(ppol) == dataclasses.asdict(jm.policy)
    pm = runner.build_model(args, pol, teacher=teacher, device="cpu")
    want = dataclasses.asdict(jm.cfg)
    got = dataclasses.asdict(pm.cfg)
    for k in set(want) | set(got):
        if k == "in_chans":  # the port's field alone
            continue
        w, g = want[k], got[k]
        if k in ("matmul_impl", "attn_impl", "compute_dtype"):
            # JAX's default spellings of the composition and fp32
            w = None if w in (None, "xla", "float32") else w
            g = None if g in (None, "xla", "float32") else g
        if isinstance(w, list):
            w = tuple(w)
        assert g == w, (k, g, w)


@pytest.mark.parametrize("kw", [
    {}, dict(batch=64), dict(qk_reparam=False), dict(img_size=384),
    dict(teacher=False, distilled=False, embed_dim=192, num_heads=3)])
def test_deit_step_flops_equal(kw):
    got, want = flops.deit_step_flops(**kw), jflops.deit_step_flops(**kw)
    assert (got.student_fwd, got.student_bwd, got.teacher_fwd, got.total) \
        == (want.student_fwd, want.student_bwd, want.teacher_fwd, want.total)
    assert got.detail == want.detail


@pytest.mark.parametrize("kw", [{}, dict(batch=48), dict(qk_reparam=False),
                                dict(teacher=False, num_classes=100)])
def test_swin_t_step_flops_equal(kw):
    got, want = flops.swin_t_step_flops(**kw), jflops.swin_t_step_flops(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cfg", [
    dict(batch_size=4, img_size=16, synthetic_length=12),
    dict(batch_size=3, img_size=8, num_classes=10, seed=7,
         synthetic_length=2, shard_index=1)])
def test_synthetic_batches_bit_equal(cfg, train):
    got = list(pipeline.synthetic_batches(pipeline.DataConfig(**cfg),
                                          train=train))
    want = list(jpipeline.synthetic_batches(jpipeline.DataConfig(**cfg),
                                            train=train))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for k in ("image", "label"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_dataset_fields_and_imagefolder_refusal(tmp_path):
    assert [f.name for f in dataclasses.fields(pipeline.DataConfig)] == [
        f.name for f in dataclasses.fields(jpipeline.DataConfig)]
    cfg = pipeline.DataConfig(data_dir=str(tmp_path))
    for call in (lambda: pipeline.make_dataset(cfg, train=True),
                 lambda: pipeline.num_samples(cfg, train=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()


def _jax_draws(key, *, H, W, mixup_alpha, cutmix_alpha, prob, switch_prob):
    """The six values `ofq_tpu.data.mixup_cutmix` draws from `key`, by its
    own lines."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
    use_mix = jax.random.uniform(k1) < prob
    if mixup_alpha > 0.0 and cutmix_alpha > 0.0:
        use_cutmix = jax.random.uniform(k2) < switch_prob
    else:
        use_cutmix = jnp.asarray(cutmix_alpha > 0.0)
    lam_mix = jax.random.beta(k3, max(mixup_alpha, 1e-8),
                              max(mixup_alpha, 1e-8))
    lam_cut = jax.random.beta(k4, max(cutmix_alpha, 1e-8),
                              max(cutmix_alpha, 1e-8))
    cy = jax.random.randint(k5, (), 0, H)
    cx = jax.random.randint(k6, (), 0, W)
    return pipeline.MixupDraws(*(torch.from_numpy(np.array(v)) for v in
                                 (use_mix, use_cutmix, lam_mix, lam_cut, cy,
                                  cx)))


MIX_CASES = [
    dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5),
    dict(mixup_alpha=0.8, cutmix_alpha=0.0, prob=1.0, switch_prob=0.5),
    dict(mixup_alpha=0.0, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5),
    dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.5, switch_prob=0.5),
]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("case", range(len(MIX_CASES)))
def test_mixup_mixing_matches_jax(case, seed):
    kw = MIX_CASES[case]
    rng = np.random.default_rng(seed)
    B, H, W, C = 6, 12, 10, 3
    batch = {"image": rng.normal(size=(B, H, W, C)).astype(np.float32),
             "label": rng.integers(0, C + 4, size=B).astype(np.int32)}
    key = jax.random.key(seed)
    want = jpipeline.mixup_cutmix(
        {k: jnp.asarray(v) for k, v in batch.items()}, key, num_classes=7,
        label_smoothing=0.1, **kw)
    draws = _jax_draws(key, H=H, W=W, **kw)
    got = pipeline.mixup_apply(
        {k: torch.from_numpy(v) for k, v in batch.items()}, draws,
        num_classes=7, label_smoothing=0.1)
    for k in ("image", "soft_label"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["label"].numpy(), batch["label"])


def test_mixup_draws_from_the_generator():
    """The draws come from the generator alone: the same seed gives the
    same draws and mixed batch, the draws lie in their ranges, and the
    soft labels sum to 1."""
    x = torch.randn(4, 8, 6, 3)
    batch = {"image": x, "label": torch.tensor([0, 1, 2, 3])}
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        d = pipeline.mixup_draws(g, height=8, width=6)
        outs.append((d, pipeline.mixup_cutmix(
            batch, torch.Generator().manual_seed(3), num_classes=5)))
    (d, a), (_, b) = outs
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)
    assert 0 <= float(d.lam_mix) <= 1 and 0 <= float(d.lam_cut) <= 1
    assert 0 <= int(d.cy) < 8 and 0 <= int(d.cx) < 6
    torch.testing.assert_close(a["soft_label"].sum(-1), torch.ones(4))
