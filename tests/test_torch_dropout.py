"""Dropout and drop-path against `ofq_tpu`, mask for mask, on the CPU.

Both frameworks take their masks, in the order they ask for them, from one
seeded numpy generator each: the test patches `jax.random.bernoulli`
(Flax's `Dropout` and `ofq_tpu/models/deit.py:_drop_path` call it) and the
port's one mask function, `ofq_tpu_torch.nn.dropout.bernoulli`.  Both must
ask for the same sequence of shapes and keep probabilities.

  * fp64 (x64, JAX's forward and gradient jitted, the masks taken while
    it traces): `deit_test_distilled` (the W2A2 QKR student and the float
    model) and `swin_test` at depths (2, 2) (W2A2 QKR and float), in train
    mode with drop_rate, attn_drop_rate and drop_path_rate above 0: the
    logits within 1e-9 of their largest magnitude and every gradient of a
    seeded loss within 1e-9 of its leaf's largest magnitude, but the LSQ
    scales' and shifts', which both frameworks sum in fp32 (1e-5 of the
    larger of that magnitude and 0.01: the q-k shifts' gradients cancel
    to ~1e-8, as the softmax is shift-invariant, about the rounding of an
    fp32 sum of their terms, ~0.07);
  * bf16: the primitives on the same bf16 tensor and mask, bit for bit
    (the kept values divided by keep rounded to bf16, as JAX's weakly
    typed constant is);
  * the per-block drop-path rates against the JAX blocks' (read with
    `flax.linen.intercept_methods`), `q_attn_mode` 0-3 gating the
    quantized attention's dropout, the fused tail's fallback (K2 and K3
    not called in train mode with attention dropout; in eval they are),
    and the generator contract: a missing generator raises, eval draws
    nothing, the same seed gives the same step.
"""

import copy
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_common import (  # noqa: F401 (jax_interpret: fixture)
    jax_interpret, jitted_init, load_into, to_jax_tree, to_numpy_tree,
    x64_jit)
from test_torch_swin_model import _with_head
from test_torch_swin_model import _jax_policy as _jax_swin_policy
from test_torch_train_loop import (BATCH, DEPTH, IMG, NAME, _jax_policy,
                                   _student_variables, _teacher_variables)
from test_torch_train_slice import _with_heads

import ofq_tpu_torch.nn.attention as tattn
import ofq_tpu_torch.nn.dropout as tdrop
from ofq_tpu.models import deit as jdeit
from ofq_tpu.models import swin as jswin
from ofq_tpu_torch.calibrate import calibrate
from ofq_tpu_torch.models import create_model
from ofq_tpu_torch.quant import (QuantPolicy, w2a2_qkr_policy,
                                 w2a2_qkr_swin_policy)
from ofq_tpu_torch.train import make_optimizer, make_train_step, TrainState

RATES = dict(drop_rate=0.1, attn_drop_rate=0.15, drop_path_rate=0.3)
SWIN, SWIN_DEPTHS = "swin_test", (2, 2)


class _Masks:
    """Masks from one seeded numpy generator, in call order, and the
    (shape, keep) of every call."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = []

    def draw(self, shape, keep):
        shape = tuple(int(s) for s in shape)
        self.calls.append((shape, float(keep)))
        return self.rng.random(shape) < keep


@pytest.fixture
def masks(monkeypatch):
    """(JAX's, the port's) mask sources, patched in."""
    mj, mt = _Masks(7), _Masks(7)

    def jax_bernoulli(key, p=0.5, shape=None, mode="low"):
        return jnp.asarray(mj.draw(shape, p))

    def port_bernoulli(shape, keep, generator):
        return torch.from_numpy(mt.draw(shape, keep))

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(tdrop, "bernoulli", port_bernoulli)
    return mj, mt


def _fp32_summed(name):
    return name.rsplit(".", 1)[-1] == "s" or "move" in name


def _loss_weights(out, seed=11):
    rng = np.random.default_rng(seed)
    outs = out if isinstance(out, tuple) else (out,)
    return [rng.normal(size=o.shape) for o in outs]


def _jax_train(jm, variables, x, weights):
    """Logits and parameter gradients of sum(out * w) in train mode."""
    v = to_jax_tree(variables, np.float64)
    rest = {k: t for k, t in v.items() if k != "params"}
    key = jax.random.key(0)

    def f(p):
        kw = dict(train=True, rngs={"dropout": key, "droppath": key})
        if rest:
            out = jm.apply({"params": p, **rest}, jnp.asarray(x),
                           mutable=list(rest), **kw)[0][0]
        else:
            out = jm.apply({"params": p}, jnp.asarray(x), **kw)[0]
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    (_, outs), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        v["params"])
    flat = {k.replace("/", "."): np.asarray(a) for k, a in
            _flatten(to_numpy_tree(g)).items()}
    return [np.asarray(o) for o in outs], flat


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port_train(tm, x, weights):
    tm.train()
    out = tm(torch.from_numpy(x), torch.Generator())
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
    names = [n for n, _ in tm.named_parameters()]
    g = torch.autograd.grad(loss, list(tm.parameters()), allow_unused=True)
    return ([o.detach().numpy() for o in outs],
            {n: (np.zeros(p.shape) if gi is None else gi.numpy())
             for n, p, gi in zip(names, tm.parameters(), g)})


def _assert_parity(masks, jm, tm, variables, x, n_calls):
    mj, mt = masks
    load_into(tm, variables)
    weights = _loss_weights(_shapes_of(tm))
    with x64_jit():
        want_out, want_g = _jax_train(jm, variables, x, weights)
    got_out, got_g = _port_train(tm, x, weights)
    assert mj.calls == mt.calls and len(mt.calls) == n_calls, (
        mj.calls, mt.calls)
    for got, want in zip(got_out, want_out):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-9 * scale
    assert set(got_g) == set(want_g)
    moved = 0
    for k, w in want_g.items():
        scale = max(float(np.abs(w).max()), 1e-300)
        if _fp32_summed(k):
            scale = max(scale, 0.01) * 1e4
        err = float(np.abs(got_g[k] - w).max()) / scale
        assert err <= 1e-9, (k, err)
        moved += bool(np.abs(w).max() > 0)
    assert moved > len(want_g) // 2
    return mt.calls


def _shapes_of(tm):
    """Zero tensors shaped like the train-mode outputs (the loss weights'
    shapes)."""
    cfg = tm.cfg
    classes = (BATCH, cfg.num_classes)
    n = 2 if getattr(cfg, "distilled", False) else 1
    return tuple(np.zeros(classes) for _ in range(n))


def _deit_models(quantized, **rates):
    pol_j = _jax_policy() if quantized else jdeit.QuantPolicy()
    pol_t = w2a2_qkr_policy(DEPTH) if quantized else QuantPolicy()
    jm = jdeit.deit_model(NAME, pol_j, **rates)
    tm = create_model(NAME, policy=pol_t, device="cpu", **rates).double()
    return jm, tm


def _deit_variables(quantized):
    if quantized:
        return _with_heads(_student_variables(3, np.float64),
                           np.random.default_rng(3))
    return _teacher_variables(4)


_INITS = {}


def _jitted_init(jm, x):
    """Variables from a jitted float32 init (the LSQ scales set from `x`
    by Flax's data-dependent init), in fp64; computed once per module
    configuration and input (a copy each call)."""
    key = (repr(jm), np.asarray(x).tobytes())
    if key not in _INITS:
        v = jitted_init(jm)(
            jax.random.key(0), jnp.asarray(x, jnp.float32))
        _INITS[key] = to_numpy_tree(v, np.float64)
    return copy.deepcopy(_INITS[key])


def _images(seed, n=BATCH):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3))


# ------------------------------------------------------------ fp64 parity
@pytest.mark.parametrize("quantized", [True, False])
def test_deit_masks_fp64(masks, quantized):
    jm, tm = _deit_models(quantized, **RATES)
    calls = _assert_parity(masks, jm, tm, _deit_variables(quantized),
                           _images(0), n_calls=1 + 4 * DEPTH + 2 * (
                               DEPTH - 1))
    # pos_drop first; block 0 has no drop-path
    assert calls[0] == ((BATCH, 18, 24), 0.9)
    assert ((BATCH, 1, 1), 0.7) in calls


@pytest.mark.parametrize("quantized", [True, False])
def test_swin_masks_fp64(masks, quantized):
    jpol = (_jax_swin_policy(SWIN_DEPTHS) if quantized
            else jswin.QuantPolicy())
    tpol = w2a2_qkr_swin_policy(SWIN_DEPTHS) if quantized else QuantPolicy()
    jm = jswin.swin_model(SWIN, jpol, depths=SWIN_DEPTHS, **RATES)
    tm = create_model(SWIN, policy=tpol, device="cpu", depths=SWIN_DEPTHS,
                      **RATES).double()
    x = _images(0)
    variables = _with_head(_jitted_init(jm, x), np.random.default_rng(1))
    n_blocks = sum(SWIN_DEPTHS)
    calls = _assert_parity(masks, jm, tm, variables, x,
                           n_calls=4 * n_blocks + 2 * (n_blocks - 1))
    # a stage-0 window's scores: 4 windows of 16 tokens per image, 2 heads
    assert calls[0] == ((BATCH * 4, 2, 16, 16), 0.85)
    assert ((BATCH, 1, 1, 1), 0.7) in calls


# ------------------------------------------------------------------ bf16
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3, 0.9])
def test_primitives_bf16_bit_for_bit(rate):
    x = np.random.default_rng(3).normal(size=(4, 9, 16)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    keep = 1.0 - rate
    m = np.random.default_rng(4).random(x.shape) < keep
    mp = np.random.default_rng(5).random((4, 1, 1)) < keep

    def patched(mask):
        return lambda key, p=0.5, shape=None, mode="low": jnp.asarray(mask)

    orig = jax.random.bernoulli
    try:
        jax.random.bernoulli = patched(m)
        want = fnn.Dropout(rate).apply({}, xj, deterministic=False,
                                       rngs={"dropout": jax.random.key(0)})
        jax.random.bernoulli = patched(mp)
        want_p = jdeit._drop_path(xj, rate, False, jax.random.key(0))
    finally:
        jax.random.bernoulli = orig
    fake = lambda mask: lambda shape, keep, generator: (  # noqa: E731
        torch.from_numpy(mask))
    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(tdrop, "bernoulli", fake(m))
        got = tdrop.dropout(xt, rate, torch.Generator(), train=True)
        mp_.setattr(tdrop, "bernoulli", fake(mp))
        got_p = tdrop.drop_path(xt, rate, torch.Generator(), train=True)
    for g, w in ((got, want), (got_p, want_p)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    # x / bf16(keep), not x * (1 / keep): the two differ somewhere
    inv = (xt * (1.0 / keep)).float().numpy()
    if rate != 0.2:  # 1 / 0.8 = 1.25 is exact
        assert np.any(inv[m] != got.float().numpy()[m])


def test_rate_one_and_eval():
    x = torch.randn(3, 4)
    g = torch.Generator()
    assert torch.equal(tdrop.dropout(x, 1.0, g, train=True),
                       torch.zeros_like(x))
    assert tdrop.dropout(x, 0.5, None, train=False) is x
    assert tdrop.drop_path(x, 0.5, None, train=False) is x


# ------------------------------------------------- rates and the policy
def _jax_block_rates(jm, x, block_cls):
    """The `drop_path` of every JAX block, in call order."""
    rates = []

    def spy(next_fun, args, kwargs, context):
        if isinstance(context.module, block_cls) and (
                context.method_name == "__call__"):
            rates.append(context.module.drop_path)
        return next_fun(*args, **kwargs)

    # traced only (`jax.eval_shape`): the rates are read while the blocks
    # are called, no value is needed
    xj = jnp.asarray(x, jnp.float32)
    v = jax.eval_shape(lambda k, xx: jm.init({"params": k}, xx, train=False),
                       jax.random.key(0), xj)
    with fnn.intercept_methods(spy):
        jax.eval_shape(lambda vv, xx: jm.apply(vv, xx, train=False), v, xj)
    return rates


def test_drop_path_rates_match_jax():
    x = _images(0, 2)
    jm = jdeit.deit_model(NAME, drop_path_rate=0.3, depth=4)
    tm = create_model(NAME, policy=QuantPolicy(), device="cpu",
                      drop_path_rate=0.3, depth=4)
    want = _jax_block_rates(jm, x, jdeit.Block)
    assert want == pytest.approx([0.0, 0.1, 0.2, 0.3], abs=1e-15)
    assert [getattr(tm, n).drop_path for n in tm.block_names] == want
    jm = jswin.swin_model(SWIN, drop_path_rate=0.2, depths=(2, 3))
    tm = create_model(SWIN, policy=QuantPolicy(), device="cpu",
                      drop_path_rate=0.2, depths=(2, 3))
    want = _jax_block_rates(jm, x, jswin.SwinBlock)
    assert len(want) == 5 and want[-1] == 0.2
    got = [getattr(tm, n).drop_path for n in tm.block_names
           if n.count("_") == 2]
    assert got == want
    # Swin-T's default 0.2 over its 12 blocks
    t = create_model("swin_t", policy=QuantPolicy(), device="cpu")
    rates = [getattr(t, n).drop_path for n in t.block_names
             if n.count("_") == 2]
    assert len(rates) == 12 and rates[0] == 0.0 and rates[-1] == 0.2


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_q_attn_mode_gates_attention_dropout(masks, mode):
    """The quantized attention's dropout runs in modes 0 and 1 only (the
    post-softmax quantizer in 0 and 3), in both frameworks: the same
    mask calls and the same logits."""
    jpol = dataclasses.replace(_jax_policy(), q_attn_mode=mode)
    tpol = dataclasses.replace(w2a2_qkr_policy(DEPTH), q_attn_mode=mode)
    assert tpol.attn_dropout_enabled == jpol.attn_dropout_enabled
    assert tpol.attn_dropout_enabled == (mode in (0, 1))
    rates = dict(attn_drop_rate=0.2)
    jm = jdeit.deit_model(NAME, jpol, **rates)
    tm = create_model(NAME, policy=tpol, device="cpu", **rates).double()
    assert tm.blocks_0.attn.attn_drop == (0.2 if mode in (0, 1) else 0.0)
    x = _images(1)
    v = _with_heads(_jitted_init(jm, x), np.random.default_rng(2))
    _assert_parity(masks, jm, tm, v, x,
                   n_calls=DEPTH if mode in (0, 1) else 0)


# ------------------------------------------------- the fused tail
def test_fused_tail_falls_back_with_attention_dropout(masks, monkeypatch,
                                                      jax_interpret):
    """attn_impl='fused' with attention dropout in train mode takes the
    composition, as JAX's does (the same masks and values); K2 and K3 are
    not called.  In eval, and in train without attention dropout, they
    are, once per block."""
    calls = {"fwd": 0, "bwd": 0}
    for k in calls:
        name = f"qkr_attention_{k}"
        real = getattr(tattn, name)

        def spy(*a, _real=real, _k=k, **kw):
            calls[_k] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tattn, name, spy)
    fused = dict(matmul_impl="fused", attn_impl="fused")
    variables = _with_heads(_student_variables(3, np.float32),
                            np.random.default_rng(3))
    x = _images(2).astype(np.float32)
    for rates, train, want in ((dict(attn_drop_rate=0.1), True, 0),
                               (dict(attn_drop_rate=0.1), False, DEPTH),
                               (dict(drop_rate=0.1, drop_path_rate=0.1),
                                True, DEPTH)):
        calls.update(fwd=0, bwd=0)
        tm = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                          **fused, **rates)
        load_into(tm, variables, torch.float32)
        tm.train(train)
        out = tm(torch.from_numpy(x), torch.Generator())
        out = out[0] if isinstance(out, tuple) else out
        if train:
            out.sum().backward()
        assert calls == {"fwd": want, "bwd": want if train else 0}, (
            rates, train, calls)
    # the fallback's values against JAX's fused model in train mode
    mj, mt = masks
    mj.calls.clear()
    mt.calls.clear()
    mj.rng = np.random.default_rng(9)
    mt.rng = np.random.default_rng(9)
    rates = dict(attn_drop_rate=0.1)
    jm = jdeit.deit_model(NAME, _jax_policy(), **fused, **rates)
    tm = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                      **fused, **rates)
    load_into(tm, variables, torch.float32)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.Generator())
    v = to_jax_tree(variables, np.float32)
    want = jm.apply(v, jnp.asarray(x), train=True,
                    rngs={"dropout": jax.random.key(0),
                          "droppath": jax.random.key(0)},
                    mutable=["quant_stats"])[0][0]
    assert mj.calls == mt.calls and len(mt.calls) == DEPTH
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * float(
            np.abs(w).max())


# ------------------------------------------------- the generator contract
def _step_case(**rates):
    m = create_model(NAME, policy=w2a2_qkr_policy(DEPTH), device="cpu",
                     generator=torch.Generator().manual_seed(0),
                     head_std=0.02, **rates)
    t = create_model(NAME, policy=QuantPolicy(), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(lambda c: 1e-3)
    step = make_train_step(m, opt, teacher=t, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(BATCH, IMG, IMG, 3)).astype(
        np.float32), "label": rng.integers(0, 1000, size=BATCH)}
    calibrate(m, batch["image"])
    return m, TrainState.create(m, opt), step, batch


def test_generator_required_and_replayed():
    m, state, step, batch = _step_case(**RATES)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        step(state, batch)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        m.train()(torch.zeros(1, IMG, IMG, 3))

    class _OnCard:
        device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="CUDA generator"):
        step(state, batch, _OnCard())
    sd = copy.deepcopy(m.state_dict())

    def one(seed):
        m.load_state_dict(sd)
        s = TrainState.create(m, make_optimizer(lambda c: 1e-3))
        _, met = step(s, batch, torch.Generator().manual_seed(seed))
        return float(met["loss"]), {k: v.clone() for k, v in
                                    s.params.items()}

    a, b, c = one(3), one(3), one(4)
    assert a[0] == b[0] and a[0] != c[0]
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert any(not torch.equal(a[1][k], c[1][k]) for k in a[1])


def test_eval_draws_nothing(monkeypatch):
    drawn = []
    monkeypatch.setattr(tdrop, "bernoulli",
                        lambda *a: drawn.append(a) or None)
    for name, pol in ((NAME, w2a2_qkr_policy(DEPTH)),
                      (SWIN, w2a2_qkr_swin_policy((1, 1)))):
        m = create_model(name, policy=pol, device="cpu", **RATES)
        m.eval()
        with torch.no_grad():
            m(torch.zeros(2, IMG, IMG, 3))
    assert drawn == []
    # a model with every rate at 0 trains without a generator
    m, state, step, batch = _step_case()
    step(state, batch)
