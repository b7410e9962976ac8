"""The port's epoch checkpoints (`train/checkpoint.py`): a save/restore
round trip is bit-exact for the whole `TrainState` (fp32 and bf16
masters, AdamW with the clipping chain, EMA, the oscillation states, the
step) and the model's buffers (BN running statistics, the image
quantizer's `signed`); the retention keeps what the JAX package's orbax
manager keeps for the same metrics (`max_to_keep`, best by metric,
latest); an interrupted save's temporary file is ignored."""

import os

import numpy as np
import pytest
import torch

from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import w2a2_qkr_policy
from ofq_tpu_torch.train import TrainState, make_optimizer, make_train_step
from ofq_tpu_torch.train import checkpoint as ckpt
from ofq_tpu_torch.train.oscillation_hook import init_oscillation_states


def _run(master_dtype, seed=0, steps=2):
    """A BN `deit_test_distilled` W2A2 QKR student after `steps` steps with
    EMA, norm clipping and the oscillation hook: (model, state, step)."""
    torch.manual_seed(seed)
    m = create_model("deit_test_distilled", policy=w2a2_qkr_policy(2),
                     device="cpu", norm_layer="batchnorm",
                     generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(lambda c: 1e-3, clip_grad=1.0, clip_mode="norm")
    state = TrainState.create(m, opt, ema=True, master_dtype=master_dtype)
    state.extra = {"oscillation": init_oscillation_states(
        state.params, bits=2, qk_reparam=True)}
    step = make_train_step(m, opt, loss_kind="ce", device="cpu",
                           ema_decay=0.9, master_dtype=master_dtype,
                           oscillation=dict(bits=2, qk_reparam=True))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = {"image": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                 "label": rng.integers(0, 1000, size=4)}
        state, _ = step(state, batch)
    return m, state, step


def _snapshot(m, state):
    out = {f"p.{k}": v.clone() for k, v in state.params.items()}
    out.update({f"w.{k}": v.clone() for k, v in m.named_parameters()})
    out.update({f"b.{k}": v.clone() for k, v in m.named_buffers()})
    out.update({f"mu.{k}": v.clone() for k, v in state.opt_state.mu.items()})
    out.update({f"nu.{k}": v.clone() for k, v in state.opt_state.nu.items()})
    out.update({f"ema.{k}": v.clone() for k, v in state.ema_params.items()})
    for n, st in state.extra["oscillation"].items():
        for f, v in st._asdict().items():
            out[f"osc.{n}.{f}"] = v.clone()
    out["count"] = torch.tensor(state.opt_state.count)
    out["step"] = torch.tensor(state.step)
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_round_trip_bit_exact(tmp_path, master_dtype):
    """Save after 2 steps, take 2 more, restore into that live state:
    every tensor equals the saved one bit for bit; the next step from the
    restored state equals the step from the saved state."""
    m, state, step = _run(master_dtype)
    assert state.params["blocks_0.attn.q_kernel"].dtype == (
        torch.bfloat16 if master_dtype == "bfloat16" else torch.float32)
    mgr = ckpt.make_manager(str(tmp_path), max_to_keep=3)
    saved = _snapshot(m, state)
    ckpt.save_epoch(mgr, 0, state, {"top1": 1.0},
                    buffers=dict(m.named_buffers()))
    rng = np.random.default_rng(9)
    batch = {"image": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 1000, size=4)}
    state, _ = step(state, batch)
    after_one = _snapshot(m, state)
    state, _ = step(state, batch)
    with pytest.raises(AssertionError):
        _assert_same(_snapshot(m, state), saved)
    restored, nxt = ckpt.restore_latest(mgr, state, m)
    assert restored is state and nxt == 1
    _assert_same(_snapshot(m, state), saved)
    state, _ = step(state, batch)
    _assert_same(_snapshot(m, state), after_one)


def test_restore_is_strict(tmp_path):
    m, state, _ = _run("float32", steps=1)
    mgr = ckpt.make_manager(str(tmp_path))
    ckpt.save_epoch(mgr, 0, state, buffers=dict(m.named_buffers()))
    payload = ckpt.load(mgr, 0)
    state.ema_params = None
    with pytest.raises(ValueError, match="EMA"):
        ckpt.restore_into(payload, state, m)
    other = create_model("deit_test_distilled", policy=w2a2_qkr_policy(2),
                         device="cpu")
    ostate = TrainState.create(other, make_optimizer(lambda c: 1e-3),
                               ema=True)
    with pytest.raises(ValueError):
        ckpt.restore_into(payload, ostate, other)


def _tiny_state(v):
    p = torch.nn.Parameter(torch.full((2,), float(v)))
    model = torch.nn.Module()
    model.w = p
    return TrainState.create(model, make_optimizer(lambda c: 1e-3))


METRICS = [0.5, 2.0, 1.0, 2.0, 0.1, 3.0, 1.5]


def test_retention_matches_orbax(tmp_path):
    """The same sequence of epoch metrics (ties included) through the
    port's manager and the JAX package's orbax manager: the same steps
    kept after each save, the same best and latest."""
    import jax.numpy as jnp

    from ofq_tpu.train import checkpoint as jckpt

    mgr = ckpt.make_manager(str(tmp_path / "port"), max_to_keep=3)
    jmgr = jckpt.make_manager(str(tmp_path / "jax"), max_to_keep=3)
    for epoch, top1 in enumerate(METRICS):
        ckpt.save_epoch(mgr, epoch, _tiny_state(epoch), {"top1": top1})
        jckpt.save_epoch(jmgr, epoch, {"w": jnp.full((2,), float(epoch))},
                         {"top1": top1})
        jmgr.wait_until_finished()
        assert mgr.all_steps() == list(jmgr.all_steps()), epoch
        assert mgr.best_step() == jmgr.best_step(), epoch
        assert mgr.latest_step() == jmgr.latest_step(), epoch
    jmgr.close()
    assert mgr.all_steps() == [1, 3, 5]


def test_saves_without_metrics_keep_the_latest(tmp_path):
    """Recovery snapshots (no metrics: every metric -inf) keep the last
    `max_to_keep` in order."""
    mgr = ckpt.make_manager(str(tmp_path), max_to_keep=2)
    for s in (4, 8, 12):
        ckpt.save_epoch(mgr, s, _tiny_state(s))
    assert mgr.all_steps() == [8, 12] and mgr.latest_step() == 12
    state = _tiny_state(0)
    ckpt.restore_latest(mgr, state)
    assert float(state.params["w"].detach()[0]) == 12.0


def test_half_written_save_is_ignored(tmp_path):
    """A save cut before its rename leaves only the temporary file: the
    step does not count, the previous checkpoint stays the latest and
    restores, and the next save of that step replaces the leftover."""
    mgr = ckpt.make_manager(str(tmp_path), max_to_keep=5)
    ckpt.save_epoch(mgr, 0, _tiny_state(1), {"top1": 1.0})
    d = os.path.join(mgr.directory, "1")
    os.makedirs(d)
    with open(os.path.join(d, "metrics.json"), "w") as f:
        f.write('{"top1": 9.0}')
    with open(os.path.join(d, "checkpoint.pt.tmp"), "wb") as f:
        f.write(b"\x80\x02half")
    assert mgr.all_steps() == [0]
    assert mgr.latest_step() == 0 and mgr.best_step() == 0
    state = _tiny_state(0)
    _, nxt = ckpt.restore_latest(mgr, state)
    assert nxt == 1 and float(state.params["w"].detach()[0]) == 1.0
    ckpt.save_epoch(mgr, 1, _tiny_state(2), {"top1": 2.0})
    assert mgr.all_steps() == [0, 1] and mgr.best_step() == 1
    assert not os.path.exists(os.path.join(d, "checkpoint.pt.tmp"))


def test_restore_best_and_empty(tmp_path):
    mgr = ckpt.make_manager(str(tmp_path), max_to_keep=10)
    assert ckpt.restore_best(mgr) is None
    assert ckpt.restore_latest(mgr, _tiny_state(0)) == (None, 0)
    for e, top1 in enumerate([1.0, 4.0, 2.0]):
        ckpt.save_epoch(mgr, e, _tiny_state(e), {"top1": top1, "top5": 9})
    best = ckpt.restore_best(mgr)
    assert float(best["params"]["w"][0]) == 1.0
    assert best["metrics"] == {"top1": 4.0, "top5": 9.0}
    by5 = ckpt.make_manager(str(tmp_path), metric_name="top5")
    assert by5.best_step() == 2  # ties: the later ranks higher
