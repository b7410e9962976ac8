"""Serving from an experiment directory (`serve.py`) against the JAX
package, with no JAX fit: an experiment of `deit_test_distilled` W2A2 QKR
trained with `--model-ema` is written by the port's checkpoint code from
JAX variables (raw weights and a different EMA).

  * `Predictor.from_experiment` loads the EMA weights: its model's logits
    equal JAX's `Predictor(model, variables)` built from the same EMA
    weights, in fp64 (x64 on the JAX side) to 1e-9 relative, the fp
    path's serving tolerance in `test_torch_deploy.py`; `predict` (fp32)
    returns the softmax of the same model;
  * `main --export` writes the codes `ofq_tpu.deploy.export_packed` gives
    the same EMA weights, bit for bit; `main --artifact --int-core`
    serves them through the integer core, its logits against JAX's frozen
    int-core model on JAX's artifact to 1e-5 (fp64; the epilogue is fp32
    on both sides, as in `test_torch_deploy.py`);
  * `main --bench-iters` prints its rate; the refusals of the artifact
    path (`--int-core` without `--artifact`, a mismatched args.yaml).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_common import to_jax_tree, to_numpy_tree, x64

import ofq_tpu.deploy as jdep
from ofq_tpu.cli import common as jcommon
from ofq_tpu.cli import runner as jrunner
from ofq_tpu.serve import Predictor as JaxPredictor
from ofq_tpu_torch import deploy as tdep
from ofq_tpu_torch import serve
from ofq_tpu_torch.cli import common, runner
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params
from ofq_tpu_torch.train import TrainState, make_optimizer
from ofq_tpu_torch.train import checkpoint as ckpt

ARGV = ["synthetic", "--model", "deit_test_distilled", "--img-size", "32",
        "--num-classes", "10", "--wq-enable", "--aq-enable", "--wq-bitw",
        "2", "--aq-bitw", "2", "--wq-per-channel", "--aq-per-channel",
        "--aq_clip_learnable", "--quantized", "--qk_reparam",
        "--model-ema"]


def _moved(tree, rng, scale):
    return jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * scale
                                   ).astype(np.float32), tree)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """(experiment dir, JAX model, JAX variables with the EMA weights,
    images)."""
    d = str(tmp_path_factory.mktemp("serve") / "exp")
    jargs = jcommon.parse_args(ARGV)
    jm = jrunner.build_model(jargs, jcommon.policy_from_namespace(jargs))
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3))
    v = to_numpy_tree(jax.jit(
        lambda k, xx: jm.init({"params": k}, xx, train=False))(
            jax.random.key(0), jnp.asarray(x, jnp.float32)), np.float32)
    rng = np.random.default_rng(1)
    raw = _moved(v["params"], rng, 0.05)
    for h in ("head", "head_dist"):
        raw[h]["kernel"] = (rng.normal(size=raw[h]["kernel"].shape) * 0.3
                            ).astype(np.float32)
    ema = _moved(raw, rng, 0.02)
    args = common.parse_args(ARGV)
    m = runner.build_model(args, common.policy_from_namespace(args),
                           device="cpu")
    load_flax_params(m, {**v, "params": raw})
    state = TrainState.create(m, make_optimizer(lambda c: 0.0), ema=True)
    state.ema_params = {k.replace("/", "."): torch.from_numpy(a) for k, a in
                        flatten_flax_tree(ema).items()}
    os.makedirs(d)
    with open(os.path.join(d, "args.yaml"), "w") as f:
        yaml.safe_dump(vars(args), f)
    ckpt.save_epoch(ckpt.make_manager(d), 0, state, {"top1": 5.0},
                    buffers=dict(m.named_buffers()))
    return d, jm, {**v, "params": ema}, x


def test_from_experiment_loads_the_ema_and_matches_jax(exp):
    d, jm, variables, x = exp
    p = serve.Predictor.from_experiment(d, batch_size=4, device="cpu")
    assert p.epoch == 0 and p.img_size == 32
    probs = p.predict(x.astype(np.float32))
    with torch.no_grad():
        p32 = torch.softmax(p.model(torch.from_numpy(x).float()), -1)
    np.testing.assert_array_equal(probs, p32.numpy())
    with x64():
        jp = JaxPredictor(jm, to_jax_tree(variables, np.float64),
                          batch_size=4, img_size=32)
        # the Predictor's function, applied without its compile
        logits, _ = jp.model.apply(jp.params, jnp.asarray(x), train=False)
        want = np.asarray(jax.nn.softmax(logits, axis=-1))
    with torch.no_grad():
        got = torch.softmax(p.model.double()(torch.from_numpy(x)),
                            -1).numpy()
    assert np.abs(want - 0.1).max() > 1e-3  # not uniform
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_export_and_int_core_artifact(exp, tmp_path, capsys):
    d, jm, variables, x = exp
    art = str(tmp_path / "art.npz")
    serve.main([d, "--export", art], device="cpu")
    et = dict(np.load(art))
    ej = jdep.export_packed(variables["params"], weight_bits=2,
                            qk_reparam=True, num_heads=3)
    meta = tdep.artifact_meta(et)
    assert meta == tdep.artifact_meta(ej)
    for key in meta["entries"]:
        np.testing.assert_array_equal(et[key + ".codes"], ej[key + ".codes"],
                                      err_msg=key)
        np.testing.assert_allclose(et[key + ".scale"], ej[key + ".scale"],
                                   rtol=1e-6, err_msg=key)
    # the port's artifact also carries the image quantizer's state
    assert set(et) - set(ej) == {"patch_embed/input_quant/signed"}
    p = serve.main([d, "--artifact", art, "--int-core", "--batch-size",
                    "4"], device="cpu")
    assert p.model.policy.frozen_int_bits == 2
    jpol = dataclasses.replace(jm.policy, weight_frozen=True,
                               frozen_int_bits=2)
    jfrozen = jm.clone(policy=jpol)
    tree = jdep.restore_packed(ej, int_core=True)
    with x64():
        want, _ = jfrozen.apply(
            {"params": to_jax_tree(tree, np.float64),
             "quant_stats": to_jax_tree(variables["quant_stats"],
                                        np.float64)},
            jnp.asarray(x), train=False)
    with torch.no_grad():
        got = p.model.double()(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    out = capsys.readouterr().out
    assert "exported" in out and "predict ok" in out


def test_bench_line_and_refusals(exp, tmp_path, capsys):
    d, _, _, _ = exp
    serve.main([d, "--bench-iters", "2", "--batch-size", "2"], device="cpu")
    assert "serving rate:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main([d, "--int-core"], device="cpu")
    art = str(tmp_path / "a.npz")
    serve.export_experiment(d, art, device="cpu")
    bad = str(tmp_path / "bad.yaml")
    with open(os.path.join(d, "args.yaml")) as f:
        saved = yaml.safe_load(f)
    with open(bad, "w") as f:
        yaml.safe_dump({**saved, "wq_bitw": 3}, f)
    with pytest.raises(ValueError, match="wrong exp_dir"):
        serve.predictor_from_artifact(art, bad, device="cpu")
