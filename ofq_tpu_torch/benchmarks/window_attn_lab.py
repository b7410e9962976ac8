"""The window-attention lab on a CUDA card: the port of
`benchmarks/window_attn_lab.py`, the lab bench of the Swin window-attention
tail at Swin-T stage 0 under the bench workload (Bn = 64 * 64 windows of
n = 49 tokens, H = 3 heads of d = 32, bf16).

    python -m ofq_tpu_torch.benchmarks.window_attn_lab [--variants v1,v2,...]
        [--check] [--device cuda]

Each of the lab's 17 variants (`VARIANTS`, the lab's names and parameters)
runs on the lab's seeded data (`_data`) through the port: the lab's XLA
compositions as plain PyTorch that keeps their dtypes at every step
(`xla_tail`, `xla_scores_only`, `xla_packed`), its Pallas kernels as the
port's CUDA kernels K6-K8 (`ofq_tpu_torch.ops.window_attention`, K6's
ablations among them).  One JSON line per variant: its time in ms, the
median of 20 calls after one more (CUDA events on a card, the host clock
on the CPU; the first line names the device and the clock).  With
`--check`, `<name>_maxerr` against `xla_tail` for the lab's set of names
(`CHECKED`), which must stay under 5e-2, as in the lab.  Unlike the lab,
which records a variant's exception and goes on, this entry point exits
non-zero when any variant raised (1) or any check failed (4).  `run` holds
the timing loop and the check, on any q, k, v.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.fused_attention import softmax
from ..ops.window_attention import (window_attn_packed,
                                    window_attn_packed_aligned,
                                    window_attn_units)

Bn, n, H, d = 64 * 64, 49, 3, 32
C = H * d
SM = d ** -0.5
# the lab's bound on |variant - xla_tail| under --check
CHECK_LIMIT = 5e-2


def _data(device="cuda", Bn=Bn):
    """The lab's q, k, v: np.random.default_rng(0) normals, in that order,
    through fp32 to bf16, on `device`."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(
        rng.normal(size=(Bn, n, H, d)).astype(np.float32)).to(
            device, torch.bfloat16) for _ in range(3))


def _bf16_sm(like):
    # the lab's weakly typed `* SM` on a bf16 array multiplies by bf16(SM)
    return torch.tensor(SM, dtype=torch.bfloat16, device=like.device)


# ----------------------------------------------------------------- XLA
def xla_tail(q, k, v):
    """The lab's `xla_tail` in its dtypes: bf16 einsum outputs, scaled in
    bf16, jax.nn.softmax on bf16 as XLA compiles it, a bf16 output."""
    attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * _bf16_sm(q)
    attn = softmax(attn, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def xla_scores_only(q, k, v):
    """The lab's `xla_scores_only`: the bf16 scores, (Bn, H, n, n)."""
    return torch.einsum("bnhd,bmhd->bhnm", q, k) * _bf16_sm(q)


def xla_packed(q, k, v, P=2):
    """The lab's `xla_packed`: P windows packed along the token axis, fp32
    scores with a block-diagonal -inf mask, fp32 softmax, p in bf16, a bf16
    output."""
    B = q.shape[0]
    pn = P * n
    qp, kp, vp = (t.reshape(B // P, pn, H, d) for t in (q, k, v))
    blk = torch.arange(pn, device=q.device) // n
    mask = torch.where(blk[:, None] == blk[None, :], 0.0, -torch.inf)
    s = torch.einsum("bnhd,bmhd->bhnm", qp.float(), kp.float()) * SM + mask
    p = softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", p, vp)
    return out.reshape(B, n, H, d)


VARIANTS = {
    "xla": lambda q, k, v: xla_tail(q, k, v),
    "xla_scores": lambda q, k, v: xla_scores_only(q, k, v),
    "xla_packed_p2": lambda q, k, v: xla_packed(q, k, v, P=2),
    "xla_packed_p4": lambda q, k, v: xla_packed(q, k, v, P=4),
    "xla_packed_p8": lambda q, k, v: xla_packed(q, k, v, P=8),
    "units16": lambda q, k, v: window_attn_units(q, k, v, WB=16),
    "units64": lambda q, k, v: window_attn_units(q, k, v, WB=64),
    "units16_nodots": lambda q, k, v: window_attn_units(
        q, k, v, WB=16, do_scores=False, do_out=False),
    "units16_nosm": lambda q, k, v: window_attn_units(
        q, k, v, WB=16, do_softmax=False),
    "units16_scoresonly": lambda q, k, v: window_attn_units(
        q, k, v, WB=16, do_softmax=False, do_out=False),
    "packed_p3": lambda q, k, v: window_attn_packed(q, k, v, WB=16, P=3),
    "packed_p6": lambda q, k, v: window_attn_packed(q, k, v, WB=16, P=6),
    "packed_p12": lambda q, k, v: window_attn_packed(q, k, v, WB=16, P=12),
    "packed_p12_wb32": lambda q, k, v: window_attn_packed(
        q, k, v, WB=32, P=12),
    "aligned_p4": lambda q, k, v: window_attn_packed_aligned(
        q, k, v, WB=16, P=4),
    "aligned_p8": lambda q, k, v: window_attn_packed_aligned(
        q, k, v, WB=16, P=8),
    "aligned_p12": lambda q, k, v: window_attn_packed_aligned(
        q, k, v, WB=16, P=12),
}
# the names the lab's --check compares with xla_tail: the tails, not the
# ablations
CHECKED = tuple(name for name in VARIANTS
                if name.startswith(("packed", "units", "xla_packed"))
                and "no" not in name and "only" not in name)


def median_ms(fn, device, reps=20):
    """Median ms of `reps` calls of `fn` after one more: CUDA events when
    `fn` runs on `device` of type cuda, else the host clock."""
    fn()
    on_card = torch.device(device).type == "cuda"
    times = []
    for _ in range(reps):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def run(q, k, v, names, check=False, emit=None):
    """Time each variant of `names` on q, k, v (and, with `check`, compare
    the CHECKED ones with xla_tail), printing one JSON line per result
    through `emit`.  Returns (results, the names that raised, the checks
    that failed)."""
    emit = emit or (lambda obj: print(json.dumps(obj), flush=True))
    out, raised, ref = {}, [], None
    for name in names:
        try:
            fn = VARIANTS[name]
            if check and name in CHECKED:
                r = fn(q, k, v)
                if ref is None:
                    ref = xla_tail(q, k, v)
                err = float(torch.max(torch.abs(r.float() - ref.float())))
                out[name + "_maxerr"] = err
                emit({name + "_maxerr": err})
            out[name] = median_ms(lambda: fn(q, k, v), q.device)
        except Exception as e:  # recorded, and the exit code says so
            out[name] = f"ERROR: {type(e).__name__}: {e}"[:160]
            raised.append(name)
        emit({name: out[name]})
    bad = {k_: v_ for k_, v_ in out.items()
           if k_.endswith("_maxerr") and not v_ < CHECK_LIMIT}
    if bad:
        emit({"check_failed": bad})
    return out, raised, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--check", action="store_true",
                    help="also compare the tails with xla_tail (< 5e-2)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("window_attn_lab: no CUDA device (pass "
                             "--device cpu for the plain versions)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    label = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(json.dumps({"device": label, "clock": "CUDA events"
                      if device.type == "cuda" else "host",
                      "Bn": Bn, "n": n, "H": H, "d": d}), flush=True)
    q, k, v = _data(device)
    names = [s.strip() for s in args.variants.split(",")]
    _, raised, bad = run(q, k, v, names, check=args.check)
    if raised:
        print(json.dumps({"raised": raised}), flush=True)
        return 1
    return 4 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
