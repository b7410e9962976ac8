"""The launch configurations of K3 (`fused_attention.bwd_launch_plan`) and
K6-K8 (`window_attention.launch_plan`) as their Python mirrors compute
them: the arithmetic at DeiT-S's shapes (N = 198 keys) and the lab's (H = 3
heads of 32, P = 3 or 4 units a pass), and the CUDA sources' constants that
the mirrors repeat, so that a source edit the mirrors miss fails here.  On
the card, `test_torch_port_cuda.py` holds each mirror equal to its built
library's launch export.

The mirrors' blocks per SM count what shared memory and threads allow on
an H100 (228 KB and 2048 threads an SM, 1 KB of each block's shared memory
reserved): two blocks of pass A fit where it takes at most 113 KB.  The
launch exports report the CUDA runtime's occupancy instead, which counts
registers too; the card test holds it at most the mirrors'.
"""

import re
from pathlib import Path

import pytest

from ofq_tpu_torch.ops import fused_attention as fa
from ofq_tpu_torch.ops import window_attention as wa

CSRC = Path(__file__).resolve().parents[1] / "ofq_tpu_torch" / "csrc"


def _constants(source):
    """`constexpr int|size_t NAME = <integer>;` of a CUDA source."""
    text = (CSRC / source).read_text()
    return {name: int(value) for name, value in re.findall(
        r"constexpr (?:int|size_t|long long) (\w+) = (\d+);", text)}


def test_mirrors_repeat_the_sources_constants():
    # K3's own and those of the score tile it shares with K2
    k3 = {**_constants("fused_attention_bwd.cu"),
          **_constants("qkr_scores.cuh")}
    assert {name: k3[name] for name in (
        "TQ", "TK", "THREADS", "A_STAGES", "A_TN", "CHUNK_BYTES",
        "ROW_BYTES", "DPQ_KEYS", "LD_ROW")} == dict(
        TQ=64, TK=64, THREADS=256, A_STAGES=3, A_TN=7, CHUNK_BYTES=32,
        ROW_BYTES=48, DPQ_KEYS=128, LD_ROW=40)
    win = _constants("window_attention.cu")
    assert {name: win[name] for name in (
        "N", "D", "NP", "TC_MAX_WARPS", "MAX_SMEM", "K6_STAGES",
        "K6_ALIGN")} == dict(
        N=49, D=32, NP=64, TC_MAX_WARPS=16, MAX_SMEM=fa._MAX_SMEM,
        K6_STAGES=2, K6_ALIGN=1024)


def test_k3_fp32_pass_a_fits_two_blocks_at_deit_s():
    """Pass A in fp32 at N = 198: the 64 x 200 score tile, 32 rows of dpq
    and three stages of 8-deep chunks (64 + 224 rows, then 32 + 224, of 12
    floats) in 113 664 bytes, at most 113 KB: two blocks per SM."""
    smem, ldp, stages, blocks = fa.bwd_launch_plan(198, bf16=False)
    assert smem == 4 * (64 * 200 + 32 * 200 + 3 * (32 + 224) * 12)
    assert smem == 113664 <= 113 * 1024
    assert (ldp, stages, blocks) == (200, 3, 2)


def test_k3_bf16_plan_at_deit_s():
    """The bf16 form keeps its pass A's 99 200 bytes (the score tile's
    three-stage ring fits where tile_nt's chunks did) and its scratch rows
    of N rounded to 8."""
    assert fa.bwd_launch_plan(198, bf16=True) == (99200, 200, 3, 2)


def test_k3_scratch_rows_are_whole_16_byte_rows():
    for N in range(1, 600):
        fp32 = fa.bwd_launch_plan(N, bf16=False)[1]
        bf16 = fa.bwd_launch_plan(N, bf16=True)[1]
        assert fp32 % 4 == 0 and N <= fp32 < N + 4, N
        assert bf16 % 8 == 0 and N <= bf16 < N + 8, N


def test_k3_fp32_keys_a_block_can_hold():
    """Pass A's score tile holds every key: up to N = 508 in the card's
    227 KB a block (the untiled form's: 384); the wrapper refuses more."""
    assert fa.bwd_launch_plan(508, bf16=False)[0] <= fa._MAX_SMEM
    assert fa.bwd_launch_plan(509, bf16=False)[0] > fa._MAX_SMEM


def test_blocks_per_sm_arithmetic():
    assert fa.blocks_per_sm(113664, 256) == 2
    assert fa.blocks_per_sm(113665 + 2048, 256) == 1
    assert fa.blocks_per_sm(0, 256) == 8       # threads bound it
    assert fa.blocks_per_sm(74752, 384) == 3


def test_k6_plan_at_the_lab_shapes():
    """K6 at H = 3: two stages of 9 unit buffers of 4096 bytes (64 rows of
    64 bytes, so each starts on the 64-byte swizzle's 512-byte repeat),
    1024 bytes to align them; one warp per 16-row tile, 12 warps; 3 blocks
    per SM as shared memory and threads allow (registers hold the full
    form to two: the card's occupancy)."""
    smem, stages, warps, blocks = wa.launch_plan("window_attn_units", 3, 3)
    assert (smem, stages, warps, blocks) == (74752, 2, 12, 3)
    unit = (smem - 1024) // (stages * 3 * 3)
    assert unit == 64 * 64 and unit % 512 == 0


@pytest.mark.parametrize("H, fits", [(1, True), (6, True), (9, True),
                                     (10, False), (12, False)])
def test_k6_heads_a_block_can_hold(H, fits):
    """Up to 9 heads' two stages fit a block; 12 (the card test's refusal)
    do not."""
    smem = wa.launch_plan("window_attn_units", H, H)[0]
    assert (smem <= fa._MAX_SMEM) == fits


def test_k78_plans_at_their_defaults():
    """K7 P 3: two 36 KB stages; K8 P 4: one 60 KB stage (two would leave
    one block per SM); 4 P warps."""
    assert wa.launch_plan("window_attn_packed", 3, 3) == (73728, 2, 12, 3)
    assert wa.launch_plan("window_attn_packed_aligned", 3, 4) == (
        61440, 1, 16, 3)


def test_k6_form_flags_are_the_launchers():
    """`form_flags`, the wrapper's encoding of K6's forms, is the one the
    CUDA launcher switches on (kFull, kNoDots, kNoSoftmax, kScoresOnly)."""
    import chip_smoke
    flags = {form: wa.form_flags(**switches) for form, switches in
             {"full": {}, **chip_smoke.K6_FORMS}.items()}
    assert flags == dict(full=7, nodots=2, nosm=5, scoresonly=1)
    assert ("kFull = 7, kNoDots = 2, kNoSoftmax = 5, kScoresOnly = 1"
            in (CSRC / "window_attention.cu").read_text())
