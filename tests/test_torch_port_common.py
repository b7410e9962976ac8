"""Helpers shared by the tests that hold `ofq_tpu_torch` against `ofq_tpu`
(no tests of its own).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU.  fp64 comparisons enable x64 for one scoped call under
`jax.disable_jit()` (jax 0.9 has no `experimental.enable_x64`), so nothing
compiled is cached against the flag.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofq_tpu.ops.fused_qlinear as jax_fq
from ofq_tpu_torch.convert import flatten_flax_tree, load_flax_params


@contextlib.contextmanager
def x64():
    """Scoped jax_enable_x64, eager."""
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.disable_jit():
            yield
    finally:
        jax.config.update("jax_enable_x64", False)


_INIT_FNS = {}


def jitted_init(jm):
    """`jax.jit` of `jm.init(..., train=False)`, one per module
    configuration (its repr), so every case that initialises that
    configuration at one input shape and dtype reuses a single compile."""
    key = repr(jm)
    if key not in _INIT_FNS:
        _INIT_FNS[key] = jax.jit(
            lambda k, xx: jm.init({"params": k}, xx, train=False))
    return _INIT_FNS[key]


@pytest.fixture
def jax_interpret(monkeypatch):
    """Run the JAX fused-QLinear Pallas kernel in interpret mode (the CPU
    has no Mosaic); the attention glue picks interpret mode by itself."""
    orig = jax_fq.fused_qlinear

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jax_fq, "fused_qlinear", interp)
    yield


def to_numpy_tree(tree, dtype=None):
    """JAX variables -> nested dict of numpy arrays (optionally cast)."""
    def conv(a):
        a = np.asarray(a)
        return a.astype(dtype) if dtype is not None else a
    return jax.tree.map(conv, jax.device_get(tree))


def to_jax_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)


def perturb(tree, rng, scale=0.05, names=("bias",)):
    """A copy of a numpy param tree with every leaf named in `names` set to
    seeded random values (so zero-initialised shifts take part)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng, scale, names)
        elif k in names:
            out[k] = (rng.normal(size=np.shape(v)) * scale).astype(
                np.asarray(v).dtype)
        else:
            out[k] = v
    return out


def without_scales(tree):
    """A copy of a numpy param tree without its LSQ scales (`s` leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = without_scales(v)
        elif k != "s":
            out[k] = v
    return out


def jax_calibrate(jmod, variables, x, **apply_kw):
    """The JAX package's calibration with the given weights in place: every
    LSQ scale is dropped and lazily re-initialised by Flax from `x` in one
    apply (as `cli/runner.py:recalibrate_missing_scales` does).  Runs in
    fp64; returns the variables with the new scales.

    Flax's `model.init` quantizes the float32-created kernels before any
    fp64 cast, so its scales are not the ones fp64 weights give; this
    recalibration is the fp64 reference for the port's `calibrate`."""
    with x64():
        v = to_jax_tree(variables, np.float64)
        pruned = {**v, "params": to_jax_tree(
            without_scales(variables["params"]), np.float64)}
        _, new = jmod.apply(pruned, jnp.asarray(x), mutable=["params"],
                            rngs={"params": jax.random.key(0)}, **apply_kw)
        return {**variables,
                "params": to_numpy_tree(new["params"], np.float64)}


def load_into(module, variables, dtype=torch.float64):
    """Load JAX variables into a port module and cast it."""
    load_flax_params(module, variables)
    return module.to(dtype)


def scale_entries(variables):
    """{'a/b/s': array} for every LSQ scale and `signed` state."""
    flat = flatten_flax_tree(variables)
    return {k: v for k, v in flat.items()
            if k.endswith("/s") or k.endswith("/signed")}


def port_state(module):
    return {k: v.detach().cpu().numpy() for k, v in
            list(module.named_parameters()) + list(module.named_buffers())}


def assert_scales_match(variables, module, rtol=1e-7):
    """Every JAX init scale equals the port's calibrated one."""
    state = port_state(module)
    entries = scale_entries(variables)
    assert entries, "no scales found"
    for path, v in entries.items():
        name = path.split("/", 1)[1] if path.split("/")[0] in (
            "params", "quant_stats") else path
        name = name.replace("/", ".")
        np.testing.assert_allclose(state[name], np.asarray(v), rtol=rtol,
                                   atol=0, err_msg=path)
