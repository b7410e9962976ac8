"""Analytic model-FLOP accounting for the QAT training step (a copy of
`ofq_tpu/utils/flops.py:38-176`, pure Python; its numbers equal the JAX
package's exactly).

One enumeration of the matmul/einsum FLOPs in the hot loop (reference
hot-loop anatomy: train.py:860-995).

Conventions:
  * FLOPs = 2 x MACs (multiply + add), matmuls/einsums only.  Elementwise
    work (STE chains, LSQ scale math, softmax, GELU, optimizer) is real
    but small (<10% — the cost_analysis cross-check bounds it) and rides
    inside fusions, so it is excluded from the *model* FLOP count that
    MFU is defined against.
  * backward = 2x forward for every matmul (dX = dY.W^T and dW = X^T.dY
    each cost the forward's MACs) EXCEPT the patch embed, whose input
    gradient is never needed (1x: dW only).
  * batch-independent terms (QKR's W_qk = Wq^T.Wk formation) are divided
    by the batch size; they vanish at B=128 but matter in small-B
    cross-checks.

QKR attention is where this differs from a vanilla ViT count (reference
attention.py:190-210): per block the chain is
    qkx  = einsum('hij,bjn->bhin', W_qk, x^T)   H.C.C.N MACs  (6x a proj!)
    attn = einsum('bnc,bhcn2->bhnn2', x, qkx)   H.N.N.C MACs
vs the vanilla q@k^T's H.N.N.d — QKR trades two C-contractions for the
low-rank d-contraction, raising the model FLOPs ~1.5x.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StepFlops:
    """GFLOPs per image, by component."""

    student_fwd: float
    student_bwd: float
    teacher_fwd: float
    detail: dict

    @property
    def total(self) -> float:
        return self.student_fwd + self.student_bwd + self.teacher_fwd


def _vit_forward_macs_per_img(*, n_tokens: int, embed_dim: int,
                              num_heads: int, depth: int,
                              num_classes: int, patch_size: int,
                              in_chans: int = 3, mlp_ratio: float = 4.0,
                              n_patches: int, distilled: bool,
                              qk_reparam: bool, batch: int) -> dict:
    """Per-image forward MACs by site.  `qk_reparam` selects the QKR
    attention algebra for q/k; v/proj/mlp are common."""
    N, C, H = n_tokens, embed_dim, num_heads
    d = C // H
    hidden = int(C * mlp_ratio)
    per_block = {}
    if qk_reparam:
        # W_qk formation: einsum('ihd,jhd->hij') — batch-independent,
        # amortized over the batch (reference attention.py:190-196)
        per_block["w_qk_form"] = H * C * C * d / batch
        per_block["v_proj"] = N * C * C
        # qkx = W_qk @ x^T : (H,C,C) x (C,N) per image
        per_block["qkx"] = H * C * C * N
        # attn logits = x @ qkx : contraction over C per head
        per_block["attn_logits"] = H * N * N * C
    else:
        per_block["qkv_proj"] = 3 * N * C * C
        per_block["attn_logits"] = H * N * N * d
    per_block["attn_v"] = H * N * N * d
    per_block["out_proj"] = N * C * C
    per_block["fc1"] = N * C * hidden
    per_block["fc2"] = N * hidden * C
    sites = {f"block/{k}": v * depth for k, v in per_block.items()}
    sites["patch_embed"] = n_patches * C * (patch_size * patch_size * in_chans)
    sites["head"] = (2 if distilled else 1) * C * num_classes
    return sites


def deit_step_flops(*, img_size: int = 224, patch_size: int = 16,
                    embed_dim: int = 384, depth: int = 12,
                    num_heads: int = 6, num_classes: int = 1000,
                    mlp_ratio: float = 4.0, distilled: bool = True,
                    qk_reparam: bool = True, batch: int = 128,
                    teacher: bool = True) -> StepFlops:
    """GFLOPs per image of one QAT optimizer step: quantized student
    forward + backward (through every STE, which is FLOP-transparent) +
    full-precision teacher forward (vanilla attention).

    Defaults = the bench workload: DeiT-S W2A2 QKR with a DeiT-S FP
    teacher (train_scripts/deit_s/w2a2_deit_s.sh)."""
    n_patches = (img_size // patch_size) ** 2
    n_tokens = n_patches + (2 if distilled else 1)
    common = dict(n_tokens=n_tokens, embed_dim=embed_dim,
                  num_heads=num_heads, depth=depth, num_classes=num_classes,
                  patch_size=patch_size, mlp_ratio=mlp_ratio,
                  n_patches=n_patches, distilled=distilled, batch=batch)
    s_sites = _vit_forward_macs_per_img(qk_reparam=qk_reparam, **common)
    g = 2.0 / 1e9  # MACs -> GFLOP
    student_fwd = sum(s_sites.values()) * g
    # backward: 2x every site INCLUDING patch_embed — the quantized patch
    # embed needs the input-gradient matmul too (trainable ImageBias and
    # the LSQ image scale sit upstream of the patchify matmul, conv.py);
    # only a float patch embed on raw images could skip dX
    student_bwd = 2.0 * sum(s_sites.values()) * g
    teacher_fwd = 0.0
    t_sites = {}
    if teacher:
        t_sites = _vit_forward_macs_per_img(qk_reparam=False, **common)
        teacher_fwd = sum(t_sites.values()) * g
    detail = {"student_fwd_sites_gflop": {k: v * g for k, v in
                                          s_sites.items()},
              "teacher_fwd_sites_gflop": {k: v * g for k, v in
                                          t_sites.items()}}
    return StepFlops(student_fwd=round(student_fwd, 3),
                     student_bwd=round(student_bwd, 3),
                     teacher_fwd=round(teacher_fwd, 3), detail=detail)


def swin_t_step_flops(*, img_size: int = 224, num_classes: int = 1000,
                      qk_reparam: bool = True, batch: int = 128,
                      teacher: bool = True) -> StepFlops:
    """Swin-T equivalent (patch 4, dims 96..768, depths [2,2,6,2], heads
    [3,6,12,24], window 7 — reference swin.py:534-544).  Attention runs
    per 49-token window; token counts halve (merge) per stage."""
    dims = [96, 192, 384, 768]
    depths = [2, 2, 6, 2]
    heads = [3, 6, 12, 24]
    window = 7
    res = img_size // 4
    s_macs = t_macs = 0.0
    Nw = window * window
    for stage, (C, dep, H) in enumerate(zip(dims, depths, heads)):
        r = res // (2 ** stage)
        n_tok = r * r              # tokens at this stage
        n_win = (r // window) ** 2
        d = C // H
        hidden = 4 * C
        for _ in range(dep):
            qkr = {
                "w_qk_form": H * C * C * d / batch,
                "v_proj": n_tok * C * C,
                "qkx": n_win * (H * C * C * Nw),
                "attn_logits": n_win * (H * Nw * Nw * C),
            }
            std = {
                "qkv_proj": 3 * n_tok * C * C,
                "attn_logits": n_win * (H * Nw * Nw * d),
            }
            common = (n_win * (H * Nw * Nw * d)      # attn@v
                      + n_tok * C * C                # out proj
                      + 2 * n_tok * C * hidden)      # fc1+fc2
            s_macs += sum((qkr if qk_reparam else std).values()) + common
            t_macs += sum(std.values()) + common
        if stage < 3:  # patch merging: (2r^2 tokens of 2C) -> r^2 of 2C
            merge = (r // 2) ** 2 * (4 * C) * (2 * C)
            s_macs += merge
            t_macs += merge
    patch = res * res * dims[0] * (4 * 4 * 3)
    head = dims[-1] * num_classes
    s_macs += patch + head
    t_macs += patch + head
    g = 2.0 / 1e9
    student_fwd = s_macs * g
    # 2x incl. the patch embed: its quantizer params need dX (see
    # deit_step_flops)
    student_bwd = 2 * s_macs * g
    teacher_fwd = t_macs * g if teacher else 0.0
    return StepFlops(student_fwd=round(student_fwd, 3),
                     student_bwd=round(student_bwd, 3),
                     teacher_fwd=round(teacher_fwd, 3), detail={})
