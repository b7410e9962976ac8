"""The port's window-attention lab (`ofq_tpu_torch.benchmarks.
window_attn_lab`) and K6's ablation forms against the JAX lab
(`benchmarks/window_attn_lab.py`), at the lab's unit shape (n = 49, H = 3,
d = 32) on seeded numpy inputs, with Bn = 32 windows unless a test says
otherwise; and the sum order of the tensor-core tile of K6-K8 emulated on
the CPU, held against the plain version under each form's gate.

Tolerances (each beside its test):
- the ablation forms' plain versions against `_mk_kernel(...)` in
  interpret mode: nodots bit-exact (exp(0) = 1, a sum of 49 ones and the
  division 1 / 49 are exact or correctly rounded in every order);
  scoresonly within one bf16 ulp plus the fp32 summation bound
  (`chip_smoke._scores_gate`: the two sum the same 32 exact products in
  other orders before rounding to bf16); nosm under the tail gate with
  p := s (`chip_smoke._tail_gate(softmax=False)`: bf16(s) may round the
  other way);
- the lab's XLA compositions: `xla_tail` and `xla_packed` under the tail
  gate (`tail_within_gate`), `xla_scores_only` within one bf16 ulp of the
  larger magnitude, at most 0.1 % of elements differing (both round the
  same fp32 sums to bf16 after sums in other orders).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_cuda import tail_within_gate
from test_torch_window_attn import _lab_call, _qkv

import chip_smoke
from ofq_tpu_torch.benchmarks import window_attn_lab as plab
from ofq_tpu_torch.ops import window_attention as wa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "benchmarks"))
import window_attn_lab as lab  # noqa: E402

BN = 32


def _bf16_pair(seed=0, Bn=BN):
    arrays = _qkv(seed, Bn)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return arrays, jx, tt


# ------------------------------------------------ (a) K6's ablation forms
@pytest.mark.parametrize("form", sorted(chip_smoke.K6_FORMS))
def test_ablation_plain_matches_lab_kernel(form):
    """Each ablation form's plain version against the lab's
    `_mk_kernel(do_scores=..., do_softmax=..., do_out=...)` body, run
    through `pl.pallas_call(interpret=True)` at WB 16."""
    switches = chip_smoke.K6_FORMS[form]
    q, k, v = _qkv(6)
    want = torch.from_numpy(
        _lab_call(lab._mk_kernel(**switches), 16, q, k, v).copy()).to(
            torch.bfloat16)
    qkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = wa.window_attn_units_reference(*qkv, **switches)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err, worst, share = chip_smoke.form_gate(form, got, want, *qkv)
    assert worst <= 1.0 and share <= chip_smoke.TAIL_DIFFERING, (
        err, worst, share)
    if form == "nodots":
        assert err == 0.0
        assert bool((got.float() == float(
            torch.tensor(1 / 49, dtype=torch.float32).bfloat16())).all())


@pytest.mark.parametrize("form, tensors, products", [
    ("full", (1, 1, 1, 1), (1, 1)),
    ("nosm", (1, 1, 1, 1), (1, 1)),
    ("scoresonly", (1, 32 / 49, 0, 1), (32 / 49, 0)),
    ("nodots", (1 / 32, 0, 0, 1), (0, 0))])
def test_form_bound_counts_what_the_function_needs(form, tensors,
                                                   products):
    """chip_smoke's bound of each K6 form counts the q, k, v and out its
    function needs (as shares of one tensor: nodots reads only q's column
    0, scoresonly only the first 32 keys of k and no v) and the q k^T and
    p v products it runs, exactly."""
    switches = chip_smoke.K6_FORMS.get(form, {})
    unit = chip_smoke.LAB_BN * chip_smoke.LAB_N * chip_smoke.LAB_H * \
        chip_smoke.LAB_D
    product = 2 * unit * chip_smoke.LAB_N
    nbytes, flops = chip_smoke.form_work(**switches)
    assert nbytes == round(2 * unit * sum(tensors))
    assert flops == round(product * sum(products))


@pytest.mark.parametrize("form", sorted(chip_smoke.K6_FORMS))
def test_ablation_wrapper_on_cpu_is_its_plain_version(form):
    switches = chip_smoke.K6_FORMS[form]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(7))
    before = {n: c.launches for n, c in wa.FORM_LAUNCHES.items()}
    got = wa.window_attn_units(q, k, v, WB=16, **switches)
    torch.testing.assert_close(
        got, wa.window_attn_units_reference(q, k, v, **switches),
        rtol=0, atol=0)
    assert {n: c.launches for n, c in wa.FORM_LAUNCHES.items()} == before


def test_full_form_is_the_tail():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(8))
    torch.testing.assert_close(
        wa.window_attn_units_reference(q, k, v, True, True, True),
        wa.window_attn_tail_reference(q, k, v), rtol=0, atol=0)


# --------------------------------------- (b) the lab's XLA compositions
def _against_jax(jax_fn, torch_fn, seed):
    _, jx, tt = _bf16_pair(seed)
    want = torch.from_numpy(np.array(
        jax.jit(jax_fn)(*jx).astype(jnp.float32))).to(torch.bfloat16)
    got = torch_fn(*tt)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    return got, want, tt


def test_xla_tail_matches_lab():
    """Under the tail gate (bf16 at every step on both sides; measured: 6
    of 150 528 elements differ, each by one ulp)."""
    got, want, tt = _against_jax(lab.xla_tail, plab.xla_tail, 9)
    ok, worst, share = tail_within_gate(got, want, *tt)
    assert ok, (worst, share)


def test_xla_scores_only_matches_lab():
    """Every element within one bf16 ulp of the larger magnitude (2^-7
    max(|y|, |ref|)), at most 0.1 % differing."""
    got, want, _ = _against_jax(lab.xla_scores_only, plab.xla_scores_only,
                                10)
    g, w = got.float(), want.float()
    d = (g - w).abs()
    assert bool((d <= 2 ** -7 * torch.maximum(g.abs(), w.abs())).all())
    assert float((d > 0).float().mean()) <= chip_smoke.TAIL_DIFFERING


@pytest.mark.parametrize("P", [2, 4, 8])
def test_xla_packed_matches_lab(P, monkeypatch):
    """Under the tail gate; the lab's `xla_packed` reshapes by its module's
    Bn, set to this test's 32 windows."""
    monkeypatch.setattr(lab, "Bn", BN)
    got, want, tt = _against_jax(
        lambda q, k, v: lab.xla_packed(q, k, v, P=P),
        lambda q, k, v: plab.xla_packed(q, k, v, P=P), 11)
    ok, worst, share = tail_within_gate(got, want, *tt)
    assert ok, (worst, share)


def test_lab_names_and_checked_set():
    """The lab's 17 names, and --check's set: the tails, not the
    ablations, not the aligned kernels (as the lab's `main` picks them)."""
    assert list(plab.VARIANTS) == list(lab.VARIANTS)
    want = [name for name in lab.VARIANTS
            if name.startswith(("packed", "units", "xla_packed"))
            and "no" not in name and "only" not in name]
    assert list(plab.CHECKED) == want
    assert (plab.Bn, plab.n, plab.H, plab.d) == (lab.Bn, lab.n, lab.H, lab.d)
    assert plab.SM == lab.SM


def test_data_is_the_labs():
    """`_data`: the lab's seeded normals (`default_rng(0)`), q, k, v drawn
    in that order, here at Bn = 8."""
    rng = np.random.default_rng(0)
    for t in plab._data("cpu", 8):
        ref = rng.normal(size=(8, lab.n, lab.H, lab.d)).astype(np.float32)
        assert t.dtype == torch.bfloat16 and t.shape == (8, 49, 3, 32)
        torch.testing.assert_close(t, torch.from_numpy(ref).bfloat16(),
                                   rtol=0, atol=0)


# ------------------------------------------------ (c) the entry point
def test_entry_function_runs_every_variant_on_cpu():
    """`run`, the entry point's timing loop and check, over all 17
    variants on the CPU (plain versions) at Bn = 64, the fewest windows
    that units64's WB divides: every variant timed, every check under the
    lab's 5e-2, nothing raised."""
    lines = []
    out, raised, bad = plab.run(*plab._data("cpu", 64), list(plab.VARIANTS),
                                check=True, emit=lines.append)
    assert raised == [] and bad == {}
    for name in plab.VARIANTS:
        assert isinstance(out[name], float) and out[name] > 0, name
    for name in plab.CHECKED:
        assert out[name + "_maxerr"] < plab.CHECK_LIMIT, name
    assert {k for line in lines for k in line} == set(out)


def test_entry_function_times_cpu_tensors_on_the_host_clock(monkeypatch):
    """`run` picks its clock from the tensors' device, not from CUDA's
    state: on CPU tensors in a process where CUDA looks initialized, no
    CUDA event is made and every time is a host time above 0."""
    def no_event(*a, **k):
        raise AssertionError("a CUDA event timed CPU work")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    out, raised, bad = plab.run(*plab._data("cpu", 16),
                                ["xla", "units16", "packed_p3"],
                                emit=lambda obj: None)
    assert raised == [] and bad == {}
    assert all(out[name] > 0 for name in ("xla", "units16",
                                          "packed_p3")), out


def test_entry_point_exits_nonzero_on_a_raising_variant(monkeypatch,
                                                        capsys):
    """`main` on the CPU at the lab's 4096 windows: a variant that raises
    is recorded and the exit code is 1."""
    def boom(q, k, v):
        raise RuntimeError("forced")
    monkeypatch.setitem(plab.VARIANTS, "units16", boom)
    rc = plab.main(["--device", "cpu", "--variants", "units16"])
    out = capsys.readouterr().out
    assert rc == 1 and "ERROR: RuntimeError: forced" in out
    assert '"raised": ["units16"]' in out
    assert json.loads(out.splitlines()[0])["clock"] == "host"


def test_entry_point_exits_nonzero_on_a_failed_check(monkeypatch, capsys):
    monkeypatch.setitem(plab.VARIANTS, "packed_p3",
                        lambda q, k, v: plab.xla_tail(q, k, v) + 0.25)
    lines = []
    _, raised, bad = plab.run(*plab._data("cpu", 16), ["packed_p3"],
                              check=True, emit=lines.append)
    assert raised == [] and set(bad) == {"packed_p3_maxerr"}
    assert {"check_failed": bad} in lines
    monkeypatch.setattr(plab, "run", lambda *a, **k: ({}, [], bad))
    assert plab.main(["--device", "cpu", "--check",
                      "--variants", "packed_p3"]) == 4


def test_entry_point_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        plab.main(["--variants", "units16"])


# -------------------------------- (d) switches only where the lab has them
@pytest.mark.parametrize("fn", [wa.window_attn_packed,
                                wa.window_attn_packed_aligned])
@pytest.mark.parametrize("switch", ["do_scores", "do_softmax", "do_out"])
def test_packed_wrappers_take_no_switch(fn, switch):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(12))
    with pytest.raises(TypeError, match=switch):
        fn(q, k, v, **{switch: False})


@pytest.mark.parametrize("switches", [
    dict(do_out=False), dict(do_scores=False),
    dict(do_scores=False, do_softmax=False),
    dict(do_scores=False, do_softmax=False, do_out=False)])
def test_units_refuses_forms_the_lab_does_not_run(switches):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(13))
    with pytest.raises(ValueError, match="none of the lab's forms"):
        wa.window_attn_units(q, k, v, **switches)


# ------------------------- (e) the tensor-core sum order, emulated on CPU
@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This file's emulations are large elementwise torch work on the CPU:
    two threads for the module, not one per core, so that the test
    workers running beside it do not oversubscribe the cores; restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def score_sums():
    """The emulated score sums (`mma_sum` of q and k, the contraction over
    d) of each chunk of the lab's data, kept for the module: every form
    that computes scores computes these same sums of the same inputs, so
    each chunk's are computed once."""
    return {}


def _emulated_gate(form, score_sums):
    """(worst |diff| / limit, share differing) of the emulated tile in
    `form` against the plain version under the form's gate
    (chip_smoke.form_gate), over the lab's 4096 windows in chunks."""
    q, k, v = plab._data("cpu")
    switches = chip_smoke.K6_FORMS.get(form, {})
    worst, differing = 0.0, 0.0
    real = chip_smoke.mma_sum
    b0 = None

    def mma_sum(a, b):
        if a.shape[-1] != plab.d:  # P V: the form's own
            return real(a, b)
        key = (b0, hash(a.contiguous().view(torch.int16).numpy().tobytes()),
               hash(b.contiguous().view(torch.int16).numpy().tobytes()))
        if key not in score_sums:
            score_sums[key] = real(a, b)
        return score_sums[key].clone()

    chip_smoke.mma_sum = mma_sum
    try:
        for b0 in range(0, plab.Bn, 128):
            qc, kc, vc = (t[b0:b0 + 128] for t in (q, k, v))
            got = chip_smoke.emulate_tc_tile(qc, kc, vc, form)
            _, w, share = chip_smoke.form_gate(
                form, got, wa.window_attn_units_reference(
                    qc, kc, vc, **switches), qc, kc, vc)
            worst, differing = max(worst, w), differing + share * got.numel()
    finally:
        chip_smoke.mma_sum = real
    return worst, differing / q.numel()


def test_tensor_core_sum_order_stays_inside_the_tail_gate(score_sums):
    """The emulated K6-K8 tile against the plain version on the lab's data
    (all 4096 windows, in chunks): every element within the tail gate and
    at most 0.1 % differing (emulated worst |diff| / limit 0.723; the
    card's expf is its own, so the card's reading may differ)."""
    worst, share = _emulated_gate("full", score_sums)
    assert worst <= 1.0 and share <= chip_smoke.TAIL_DIFFERING, (worst,
                                                                 share)
    assert share > 0  # another order than the plain version's


@pytest.mark.parametrize("form", sorted(chip_smoke.K6_FORMS))
def test_k6_forms_tensor_core_sum_order_stays_inside_their_gates(
        form, score_sums):
    """K6's ablation forms on the tensor-core tile, emulated with the card's
    accumulator (`chip_smoke.mma_sum`, whose bits the card run holds equal
    to the kernel's in these forms), against their plain versions on the
    lab's data: each inside its unchanged gate (emulated worst |diff| /
    limit: nosm 0.477, 8.9e-5 of the elements differing; scoresonly 0.991,
    1.6e-5; nodots bit-exact)."""
    worst, share = _emulated_gate(form, score_sums)
    assert worst <= 1.0 and share <= chip_smoke.TAIL_DIFFERING, (worst,
                                                                 share)
    if form == "nodots":
        assert worst == 0.0 and share == 0.0


def test_mma_sum_cuts_below_the_largest_unnormalized_exponent():
    """One k16 step: 1.5 * 1.5 (unnormalized exponent 0) and fifteen
    products of 2^-25 (kept: the cut is below 2^-25; with the normalized
    exponent 1 it would be below 2^-24 and drop them), summed exactly to
    2.25 + 1.875 * 2^-22, cut toward zero to fp32: 2.25 + 2^-22 (round to
    nearest would give 2.25 + 2^-21)."""
    a = torch.tensor([1.5] + [2 ** -13] * 15).to(torch.bfloat16)
    b = torch.tensor([1.5] + [2 ** -12] * 15).to(torch.bfloat16)
    assert chip_smoke.mma_sum(a, b).item() == 2.25 + 2 ** -22
    assert chip_smoke.mma_sum(-a, b).item() == -(2.25 + 2 ** -22)
    # the running sum joins the next step's alignment: 2.25 + 2^-22 again
    a2, b2 = torch.cat([a, a]), torch.cat([b, torch.zeros(16).to(b.dtype)])
    assert chip_smoke.mma_sum(a2, b2).item() == 2.25 + 2 ** -22


def test_mma_sum_error_is_inside_the_kernels_share_of_the_scores_gate():
    """The scores gate (`chip_smoke._scores_gate`) allows two fp32 sums of
    32 terms, 2 x 32 x 2^-24 sum_d |q_d k_d| (before the scale), half for
    each side.  The card's accumulator loses less than 17 x 2^-25 x the
    step's largest term plus 2^-23 x |sum| a k16 step, at most 21 x 2^-24
    sum |q k| over d = 32; on the lab's first 512 windows the emulated
    sums read at most 2.13 x 2^-24 sum |q k| from the exact ones."""
    q, k, _ = plab._data("cpu", 512)
    qu, ku = (t.permute(0, 2, 1, 3) for t in (q, k))
    acc = chip_smoke.mma_sum(qu.unsqueeze(3), ku.unsqueeze(2)).double()
    exact = torch.einsum("bhid,bhjd->bhij", qu.double(), ku.double())
    size = torch.einsum("bhid,bhjd->bhij", qu.double().abs(),
                        ku.double().abs())
    worst = float(((acc - exact).abs() / (size * 2 ** -24)).max())
    assert 0 < worst <= 21 < 32, worst
