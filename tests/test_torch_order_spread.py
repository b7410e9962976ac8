"""The whole-step gradient rule's order spread, on the CPU.

`chip_smoke.summed_in_chunks(j)` runs the plain path with every product
(torch.matmul, torch.einsum, `@`, and through autograd their backward
products) in another legitimate fp32 summation order: the contraction
split into j chunks, each summed in fp32, the chunks added in fp32 in
order, the result rounded once to the dtype it returns.  The bf16 gates
allow each parameter of a whole train step 2 x the largest distance from
the rounded-once reference over these orders (`_grad_gate`).  This file
holds the context to that description and the rule to its limit.
Inputs come from seeded numpy.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

U32 = 2.0 ** -24  # fp32's unit roundoff


def _operands(seed, shape_a, shape_b, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=shape_a).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=shape_b).astype(np.float32))
    return a.to(dtype), b.to(dtype)


def _chunked_by_hand(a, b, j):
    """a (M, K) @ b (K, N): K in j near-equal chunks, each an fp32
    product, the chunks added in fp32 in order."""
    acc = None
    for ca, cb in zip(torch.tensor_split(a.float(), j, dim=1),
                      torch.tensor_split(b.float(), j, dim=0)):
        part = torch.matmul(ca, cb)
        acc = part if acc is None else acc + part
    return acc


@pytest.mark.parametrize("j", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_in_chunks_is_the_stated_order(j, dtype):
    """torch.matmul, `@` and the equivalent einsum give the stated order's
    sum rounded once to the operands' dtype, within fp32's bound of the
    fp64 sum: K u sum |a||b| (K = 301 terms, u = 2^-24), plus half an
    ulp of the output dtype."""
    a, b = _operands(j, (23, 301), (301, 17), dtype)
    with chip_smoke.summed_in_chunks(j):
        y = torch.matmul(a, b)
        y_op = a @ b
        y_es = torch.einsum("mk,kn->mn", a, b)
    want = _chunked_by_hand(a, b, j).to(dtype)
    assert y.dtype == dtype
    assert torch.equal(y, want)
    assert torch.equal(y_op, want) and torch.equal(y_es, want)
    exact = a.double() @ b.double()
    abs_sum = a.double().abs() @ b.double().abs()
    ulp = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
    lim = 301 * U32 * abs_sum + ulp * exact.abs()
    assert bool(((y.double() - exact).abs() <= lim).all())


def test_chunks_change_the_sum():
    """On seeded inputs the chunked orders give other fp32 sums than
    torch.matmul's own (the spread the rule measures is not zero)."""
    a, b = _operands(7, (64, 999), (999, 64))
    plain = torch.matmul(a, b)
    for j in chip_smoke.ORDER_CHUNKS:
        with chip_smoke.summed_in_chunks(j):
            y = torch.matmul(a, b)
        assert not torch.equal(y, plain), j


def test_einsum_of_the_port_in_chunks():
    """A product of the attention tail (`bnc,bmhc->bhnm`, the operands
    given as a list too): the chunked sum within fp32's bound of fp64."""
    a, b = _operands(3, (2, 5, 40), (2, 6, 3, 40))
    with chip_smoke.summed_in_chunks(3):
        y = torch.einsum("bnc,bmhc->bhnm", a, b)
        y_list = torch.einsum("bnc,bmhc->bhnm", [a, b])
    exact = torch.einsum("bnc,bmhc->bhnm", a.double(), b.double())
    abs_sum = torch.einsum("bnc,bmhc->bhnm", a.double().abs(),
                           b.double().abs())
    assert y.shape == (2, 3, 5, 6) and torch.equal(y, y_list)
    assert bool(((y.double() - exact).abs()
                 <= 40 * U32 * abs_sum + U32 * exact.abs()).all())


@pytest.mark.parametrize("shape_a,shape_b", [
    ((4, 7, 30), (30, 5)), ((30,), (30, 5)), ((6, 30), (30,)),
    ((30,), (30,))])
def test_matmul_shapes(shape_a, shape_b):
    a, b = _operands(11, shape_a, shape_b)
    with chip_smoke.summed_in_chunks(2):
        y = torch.matmul(a, b)
    ref = torch.matmul(a.double(), b.double())
    assert y.shape == ref.shape
    assert torch.allclose(y.double(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_products_in_chunks(dtype):
    """Through autograd, the cotangents a and b receive are themselves
    products summed in chunks (g @ b^T over N, a^T @ g over M), rounded
    once to the operands' dtype."""
    a, b = _operands(5, (40, 90), (90, 70), dtype)
    g = _operands(6, (40, 70), (1, 1), dtype)[0]
    a.requires_grad_()
    b.requires_grad_()
    with chip_smoke.summed_in_chunks(3):
        y = torch.matmul(a, b)
        ga, gb = torch.autograd.grad(y, (a, b), g)
    assert ga.dtype == gb.dtype == dtype
    assert torch.equal(ga, _chunked_by_hand(g, b.detach().T, 3).to(dtype))
    assert torch.equal(gb, _chunked_by_hand(a.detach().T, g, 3).to(dtype))


def test_restored_on_exit_and_after_an_exception():
    mm, es, op = torch.matmul, torch.einsum, torch.Tensor.__matmul__
    with chip_smoke.summed_in_chunks(2):
        assert torch.matmul is not mm and torch.einsum is not es
        assert torch.Tensor.__matmul__ is not op
    assert torch.matmul is mm and torch.einsum is es
    assert torch.Tensor.__matmul__ is op
    with pytest.raises(ZeroDivisionError):
        with chip_smoke.summed_in_chunks(4):
            1 / 0
    assert torch.matmul is mm and torch.einsum is es
    assert torch.Tensor.__matmul__ is op


def test_integer_products_pass_through_and_others_are_refused():
    """Integer products are exact in any order; a floating product the
    context cannot split raises rather than keep its own order."""
    a = torch.arange(6).reshape(2, 3)
    with chip_smoke.summed_in_chunks(2):
        y = a @ a.T
        assert y.dtype == torch.int64 and torch.equal(y, a @ a.T)
        x = torch.ones(2, 3, 4)
        with pytest.raises(NotImplementedError):
            torch.matmul(x, x.transpose(1, 2))
        with pytest.raises(NotImplementedError):
            torch.einsum("ij,jk,kl->il", x[0], x[0].T, x[0])
        with pytest.raises(NotImplementedError):
            torch.einsum("...j,jk", x, x[0].T)


def _row(name, kernels, plain, spread=None):
    r = dict(name=name, rel_kernels=kernels, rel_plain=plain)
    if spread is not None:
        r["spread"] = spread
    return r


def test_rule_allows_twice_the_order_spread_plus_the_floor():
    """Each parameter at most 2 x its order spread + the floor (the median
    plain distance, at least GRAD_GATE_MIN_FLOOR); all parameters
    together the same; a row past its limit trips the gate."""
    rows = [_row("a", 0.5, 0.1, 0.3), _row("b", 0.2, 0.2, 0.2),
            _row("c", 0.05, 0.3, 0.4)]
    glob = {"kernels": 0.3, "plain": 0.2, "spread": 0.25}
    floor = chip_smoke._grad_gate("test", rows, dict(glob))
    assert floor == 0.2
    # a: 0.5 <= 2 * 0.3 + 0.2; one past the limit trips
    rows[0]["rel_kernels"] = 2 * 0.3 + 0.2 + 1e-9
    with pytest.raises(chip_smoke.GateTripped):
        chip_smoke._grad_gate("test", rows, dict(glob))
    rows[0]["rel_kernels"] = 0.5
    with pytest.raises(chip_smoke.GateTripped):
        chip_smoke._grad_gate("test", rows, dict(glob, kernels=0.7 + 1e-9))


def test_rule_without_spread_is_the_plain_rule():
    """The fp32 gate (and each block's backward) keeps 2 x plain + floor,
    the floor at least GRAD_GATE_MIN_FLOOR."""
    rows = [_row("a", 3e-3, 1e-3), _row("b", 0.0, 0.0), _row("c", 0.0, 0.0)]
    assert chip_smoke._grad_gate("test", rows) == \
        chip_smoke.GRAD_GATE_MIN_FLOOR
    rows[0]["rel_kernels"] = 3e-3 + 1e-9
    with pytest.raises(chip_smoke.GateTripped):
        chip_smoke._grad_gate("test", rows)
