"""The layers of the pallas configuration against the Flax modules of
`ofq_tpu.nn`, on the CPU: `matmul_impl='pallas'` in fp64 (x64, the Pallas
kernel in interpret mode), `QLinear`, `QMlp` and `QAttentionQKR`, the
output, dx and every parameter's gradient, with the tolerances of
`test_torch_train_layers.py`.  The bf16 stream's layers:
`test_torch_bf16_layers.py`.
"""

import numpy as np
import pytest

from test_torch_train_layers import C, H, N, _check_grads_fp64, _tokens

from ofq_tpu.nn import attention as jattn
from ofq_tpu.nn import linear as jlin
from ofq_tpu.ops import pallas_statsq as jps
from ofq_tpu_torch.nn import QAttentionQKR, QLinear, QMlp


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX StatsQ matmul kernel in interpret mode (no Mosaic on the
    CPU); `statsq_matmul(impl='pallas')` looks it up at call time."""
    orig = jps.pallas_statsq_matmul

    def interp(x, k, b, **kw):
        return orig(x, k, b, **{**kw, "interpret": True})
    monkeypatch.setattr(jps, "pallas_statsq_matmul", interp)


# ------------------------------------------------------- pallas, fp64
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [2, 4])
def test_qlinear_pallas_grads_fp64(jax_pallas_interpret, symmetric, bits):
    x = _tokens(20, positive=not symmetric)
    kw = dict(weight_bits=bits, input_bits=bits, symmetric=symmetric)
    _check_grads_fp64(jlin.QLinear(16, matmul_impl="pallas", **kw),
                      QLinear(C, 16, N, matmul_impl="pallas", **kw), x)


def test_qmlp_pallas_grads_fp64(jax_pallas_interpret):
    kw = dict(weight_bits=2, input_bits=2)
    _check_grads_fp64(
        jlin.QMlp(hidden_features=48, out_features=C, matmul_impl="pallas",
                  **kw),
        QMlp(C, 48, C, N, matmul_impl="pallas", **kw), _tokens(21))


@pytest.mark.parametrize("quantize_softmax", [True, False])
def test_qattention_qkr_pallas_grads_fp64(jax_pallas_interpret,
                                          quantize_softmax):
    kw = dict(weight_bits=2, input_bits=2, quantize_softmax=quantize_softmax)
    _, _, gj = _check_grads_fp64(
        jattn.QAttentionQKR(num_heads=H, matmul_impl="pallas", **kw),
        QAttentionQKR(C, H, N, matmul_impl="pallas", **kw), _tokens(22))
    assert np.abs(gj["proj.kernel"]).max() > 0

