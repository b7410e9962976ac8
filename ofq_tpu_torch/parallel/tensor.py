"""Tensor parallelism over the mesh's 'model' axis (the 'model' axis of
`ofq_tpu/parallel/mesh.py`): the DeiT and Swin students, quantized (W2A2,
with and without QKR, full-LSQ, 32-bit sites, an unquantized softmax, any
MLP activation) or float, with LayerNorm or BatchNorm, with or without
remat, sharded by JAX's Megatron table (`param_spec`), each block's heads
and MLP columns split over the ranks of a model group.

The JAX package annotates the parameters and lets GSPMD place the
collectives; the port writes them into the model's autograd graph, each
an op of this module run over the model group:

  * `copy_to_model` (Megatron's f): the identity forward, an all-reduce
    of the cotangent backward.  On QKR's shared quantized input (its v
    product, the per-head `x W_qk` and the attention's lhs each give a
    partial gradient), on the composed column-parallel product's input
    (fc1, and `qkv` without QKR), and on every scale whose input is
    sharded (the softmax scale, the per-token q and k scales without QKR,
    the row-parallel linears' input scales): their `ds` sums over heads
    or channels of other ranks;
  * `reduce_from_model` (g): an all-reduce forward, the identity
    backward: after the composed row-parallel products (`proj`, `fc2`),
    before their bias; the float and 32-bit sites' plain products
    (`Dense`, an unquantized `QLinear`) take f and g the same way.  The
    kernels' own functions (K1, K4) reduce inside their forward and
    backward (`ops/`);
  * `gather_rows`: a row-parallel kernel's rows gathered (exact), for its
    StatsQ scale (2 mean|W| over the whole in-axis: the single process's
    bits) and K1's bvec; `model_sum` / `model_min` / `model_max`: the
    reductions of K1's integer sums, of a row-parallel product's partial
    sums and of CGA's level range, without a gradient.

Every collective sums in at least fp32 and returns its input's dtype, so
a partial sum leaves a rank unrounded where the single process would sum
on (the row-parallel products hand their fp32 accumulators to the
all-reduce and round the sum once).

`shard_model` cuts a calibrated, loaded model in place: each rank keeps
the columns of its heads and MLP units in the column-parallel kernels
(q, k, v, fc1; without QKR, and in a float attention, the q, k and v
column blocks of its heads in `qkv`, not JAX's contiguous columns), the
rows in the row-parallel ones (proj, fc2), the head columns of a window
attention's relative-position bias table, and the slices of the shifts
and scales that only its heads or columns use (an RPReLU's per-channel
shifts and slopes among them; JAX keeps those replicated: a storage
difference, the numbers are the same).  Every other parameter stays
whole: the embeddings, norms (BatchNorm's running statistics too: the
ranks of a model group see the same rows), head, a PReLU's one slope
(its cotangent summed over the group), Swin's patch-merging reductions
and its shared shift masks.  Where the model group's width does not
divide a block's heads (Swin-T's stage 0 and DeiT-T at 2 ranks: 3
heads), that block's attention stays whole on every rank, computed alike
with no collective and a proj that is not row-parallel; likewise an MLP
whose hidden width it does not divide.  (JAX cuts such kernels mid-head and lets GSPMD
reshard: the same numbers, fewer bytes a rank.)  Its `Layout` says how
each sliced parameter was cut, cuts full tensors (a checkpoint's, a
state's) and gathers the slices back into full tensors (the checkpoint a
rank writes holds the single process's names, shapes and dtypes).

A block under remat (`nn/dropout.py:checkpointed`, the checkpointed
attention tail) replays its forward in the backward, and with it the
model group's collectives of that forward: every rank of the group runs
the same graph, and autograd replays a block when its first saved
tensor is needed, at the same place in the backward's order on every
rank, so the replayed collectives pair up as the forward's did.

A frozen artifact is not sharded, and `serve.Predictor` takes no sharded
model: the JAX package serves and freezes on one device
(`check_shardable`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.distributed as dist

def _active(mesh) -> bool:
    return (mesh is not None and mesh.model_parallel > 1
            and dist.is_initialized())


def _all_reduce(t: torch.Tensor, mesh, op=None) -> torch.Tensor:
    """`t` reduced over the model group, a float in at least fp32, an
    integer in its own dtype (exact), returned in its dtype (a new
    tensor)."""
    hi = (torch.promote_types(t.dtype, torch.float32)
          if t.is_floating_point() else t.dtype)
    out = t.detach().to(hi, copy=True).contiguous()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=mesh.model_group)
    return out.to(t.dtype)


def model_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed over the model group (no gradient)."""
    return _all_reduce(t, mesh) if _active(mesh) else t


def model_min(t: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.MIN) if _active(mesh) else t


def model_max(t: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.MAX) if _active(mesh) else t


def gather_rows(t: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """The full tensor whose slices along `axis` the model group's ranks
    hold, in model order (every rank's slice broadcast over the group:
    exact); `t` itself outside an active model group.  No gradient."""
    if not _active(mesh):
        return t
    t = t.detach().contiguous()
    base = mesh.data_index * mesh.model_parallel
    parts = []
    for m in range(mesh.model_parallel):
        buf = t.clone() if m == mesh.model_index else torch.empty_like(t)
        dist.broadcast(buf, src=base + m, group=mesh.model_group)
        parts.append(buf)
    return torch.cat(parts, dim=axis)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        return _all_reduce(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """f: `t` itself; its cotangent summed over the model group."""
    if not _active(mesh) or not t.requires_grad:
        return t
    return _CopyToModel.apply(t, mesh)


def reduce_from_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """g: `t` summed over the model group; its cotangent passed on."""
    if not _active(mesh):
        return t
    return _ReduceFromModel.apply(t, mesh)


def tp_roles(tp):
    """(mesh or None, mesh or None): a linear's `tp` argument, ('row',
    mesh), ('col', mesh) or None, as (row-parallel, column-parallel)."""
    if tp is None:
        return None, None
    role, mesh = tp
    return (mesh, None) if role == "row" else (None, mesh)


def model_global_shape(shape, model) -> tuple:
    """`shape` with axis `model[0]` (sharded over the model group) at its
    global length: times `model[1]`; `shape` itself for None."""
    shape = tuple(shape)
    if model is None:
        return shape
    axis, parts = model
    axis %= len(shape)
    return shape[:axis] + (shape[axis] * parts,) + shape[axis + 1:]


# --------------------------------------------------------------- the cuts
@dataclasses.dataclass(frozen=True)
class Cut:
    """How one parameter is split over the model group: its full tensor
    (of `shape`), seen as `view`, is cut along `axis` of the view into
    `parts` equal slices; model index m keeps slice m.  A view other than
    the shape is a strided slice of the shape's last axis (`quan_qkx.s`:
    (N * H,) seen as (N, H), the heads along axis 1; `qkv.kernel`: (C,
    3C) seen as (C, 3, H, d), a rank's q, k and v column blocks)."""
    shape: tuple
    view: tuple
    axis: int
    parts: int

    @property
    def local_view(self) -> tuple:
        v = list(self.view)
        v[self.axis] //= self.parts
        return tuple(v)

    @property
    def local_shape(self) -> tuple:
        if self.view == self.shape:
            return self.local_view
        return self.shape[:-1] + (self.shape[-1] // self.parts,)

    @property
    def shape_axis(self) -> int:
        """The axis of `shape` that the cut divides (a strided view divides
        the last)."""
        return self.axis if self.view == self.shape else len(self.shape) - 1

    @property
    def row_parallel(self) -> bool:
        """A kernel cut along its in-axis (StatsQ's reduction axis)."""
        return len(self.shape) == 2 and self.axis == 0

    def local(self, full: torch.Tensor, index: int) -> torch.Tensor:
        n = self.local_view[self.axis]
        t = full.reshape(self.view).narrow(self.axis, index * n, n)
        return t.reshape(self.local_shape).contiguous()


def _cut(shape, parts, axis=0, view=None) -> Cut:
    return Cut(tuple(shape), tuple(view or shape), axis, parts)


def block_cuts(prefix: str, C: int, H: int, N: int, hidden: int,
               parts: int, *, qkr: bool = True, window: int | None = None,
               attention: bool = True, mlp: bool = True,
               lsq: bool = False, rprelu: bool = False) -> dict:
    """{parameter name: Cut} of one W2A2 block at `parts` model ranks:
    `param_spec`'s sharded kernels and biases, and the shifts and scales
    only a rank's heads or columns use.  The attention is QKR's (`qkr`) or
    the single `qkv` linear's, cut by head; a window attention (`window`:
    Swin's window size) also cuts its relative-position bias table's head
    columns.  `attention` / `mlp` False: that half stays whole (the
    model group's width does not divide its heads / hidden units).  With
    full-LSQ weights (`lsq`) the column-parallel linears' per-column
    weight scales are cut with their columns; a row-parallel linear keeps
    its whole.  An RPReLU activation (`rprelu`) cuts its per-channel
    shifts and slopes with fc1's columns."""
    a, m = f"{prefix}.attn", f"{prefix}.mlp"
    cuts = {}
    if attention and qkr:
        cuts.update({f"{a}.{k}": _cut((C, C), parts, 1)
                     for k in ("q_kernel", "k_kernel", "v_kernel")})
        for k in ("v_bias", "move_v_b4.bias"):
            cuts[f"{a}.{k}"] = _cut((C,), parts)
        for k in ("move_qkx_b4.bias", "move_qkx_aft.bias"):
            cuts[f"{a}.{k}"] = _cut((H * C,), parts)
        cuts[f"{a}.quan_qkx.s"] = _cut((N * H,), parts, 1, view=(N, H))
    elif attention:
        # a rank's heads in each of the q, k and v thirds of qkv's columns
        d = C // H
        cuts[f"{a}.qkv.kernel"] = _cut((C, 3 * C), parts, 2,
                                       view=(C, 3, H, d))
        for k in ("qkv.bias", "move_qkv_b4.bias"):
            cuts[f"{a}.{k}"] = _cut((3 * C,), parts, 1, view=(3, H, d))
        for k in ("move_q_aft.bias", "move_k_aft.bias"):
            cuts[f"{a}.{k}"] = _cut((C,), parts)
        if lsq:
            cuts[f"{a}.qkv.weight_quant.s"] = _cut((3 * C,), parts, 1,
                                                   view=(3, H, d))
    if attention:
        for k in ("quan_v.s", "move_v_aft.bias", "proj.move_b4.bias",
                  "proj.move_aft.bias"):
            cuts[f"{a}.{k}"] = _cut((C,), parts)
        cuts[f"{a}.proj.kernel"] = _cut((C, C), parts, 0)
        if window is not None:
            cuts[f"{a}.relative_position_bias_table"] = _cut(
                ((2 * window - 1) ** 2, H), parts, 1)
    if mlp:
        cuts[f"{m}.fc1.kernel"] = _cut((C, hidden), parts, 1)
        cuts[f"{m}.fc1.bias"] = _cut((hidden,), parts)
        if lsq:
            cuts[f"{m}.fc1.weight_quant.s"] = _cut((hidden,), parts)
        if rprelu:
            for k in ("move1", "alpha", "move2"):
                cuts[f"{m}.act.{k}"] = _cut((hidden,), parts)
        cuts[f"{m}.fc2.kernel"] = _cut((hidden, C), parts, 0)
        for k in ("move_b4.bias", "move_aft.bias"):
            cuts[f"{m}.fc2.{k}"] = _cut((hidden,), parts)
    return cuts


@dataclasses.dataclass
class Layout:
    """The sharded parameters of a model on `mesh`, by name."""
    mesh: object
    cuts: dict

    def cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of parameter `name`'s full tensor (the tensor
        itself for a parameter that stays whole)."""
        c = self.cuts.get(name)
        if c is None:
            return full
        if tuple(full.shape) != c.shape:
            raise ValueError(f"{name}: a full tensor of {tuple(full.shape)}, "
                             f"the layout cuts {c.shape}")
        return c.local(full, self.mesh.model_index)

    def cut_all(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        return {n: self.cut(n, t) for n, t in tensors.items()}

    def gather(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        """{name: full tensor} of {name: this rank's slice}: every model
        rank's slices broadcast over the model group, one bucket per dtype
        and source rank (every rank of the group must call it with the
        same names).  Exact: the slices travel as they are."""
        out = dict(tensors)
        names = [n for n in tensors if n in self.cuts]
        if not names or not _active(self.mesh):
            return out
        mesh = self.mesh
        full = {n: torch.empty(self.cuts[n].view, dtype=tensors[n].dtype,
                               device=tensors[n].device) for n in names}
        by_dtype: dict = {}
        for n in names:
            by_dtype.setdefault((tensors[n].dtype, tensors[n].device),
                                []).append(n)
        base = mesh.data_index * mesh.model_parallel
        for (dt, dev), group in by_dtype.items():
            sizes = [math.prod(self.cuts[n].local_view) for n in group]
            for m in range(mesh.model_parallel):
                if m == mesh.model_index:
                    buf = torch.cat([tensors[n].reshape(-1) for n in group])
                else:
                    buf = torch.empty(sum(sizes), dtype=dt, device=dev)
                dist.broadcast(buf, src=base + m, group=mesh.model_group)
                for n, piece in zip(group, torch.split(buf, sizes)):
                    c = self.cuts[n]
                    k = c.local_view[c.axis]
                    full[n].narrow(c.axis, m * k, k).copy_(
                        piece.view(c.local_view))
        for n in names:
            out[n] = full[n].reshape(self.cuts[n].shape)
        return out

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the full gradients: the squares of the
        sliced ones summed over the model group, the whole ones counted
        once."""
        sliced = [g for n, g in grads.items() if n in self.cuts]
        whole = [g for n, g in grads.items() if n not in self.cuts]

        def sq(ts):
            if not ts:
                return torch.zeros((), dtype=torch.float32,
                                   device=self.mesh.device)
            return torch.sum(torch.stack(torch._foreach_norm(ts)) ** 2)

        return torch.sqrt(model_sum(sq(sliced), self.mesh) + sq(whole))

    def sq_sum(self, name: str, t: torch.Tensor, dims=None,
               keepdim: bool = False) -> torch.Tensor:
        """The sum of `t`'s squares over `dims` (all of them for None) as
        the full tensor of parameter `name` gives it: summed over the model
        group where `t` is a slice cut along one of `dims`."""
        dims = tuple(range(t.ndim)) if dims is None else tuple(
            d % t.ndim for d in dims)
        sq = torch.sum(t * t, dim=dims, keepdim=keepdim) if dims else t * t
        c = self.cuts.get(name)
        return (model_sum(sq, self.mesh)
                if c is not None and c.shape_axis in dims else sq)

    def cut_states(self, states):
        """This rank's slices of per-weight states ({name: NamedTuple} of
        full tensors, e.g. the oscillation hook's): each field of its
        parameter's full shape is cut, a scalar (a step count) kept."""
        if not states:
            return states
        out = {}
        for n, st in states.items():
            c = self.cuts.get(n)
            out[n] = st if c is None else type(st)(*(
                self.cut(n, f) if tuple(f.shape) == c.shape else f
                for f in st))
        return out

    def gather_states(self, states):
        """The full per-weight states of this rank's slices (a collective
        over the model group)."""
        if not states:
            return states
        out = {n: list(st) for n, st in states.items()}
        for i in range(len(next(iter(states.values())))):
            part = {n: st[i] for n, st in states.items()
                    if n in self.cuts and st[i].ndim}
            for n, t in self.gather(part).items():
                out[n][i] = t
        return {n: type(states[n])(*v) for n, v in out.items()}

    def shard_state(self, state, model: torch.nn.Module):
        """`state` (of the full model, built before `shard_model` cut it)
        on this rank: fp32 masters become the model's sliced parameters,
        bf16 masters, the moments, the EMA and the oscillation hook's
        states are cut; `state.tp` holds the layout."""
        masters = dict(model.named_parameters())
        if set(masters) != set(state.params):
            raise ValueError("the state's parameters are not the model's")
        if any(p.dtype == torch.bfloat16 for p in state.params.values()):
            state.params = self.cut_all(state.params)
        else:
            state.params = masters
        state.opt_state = dataclasses.replace(
            state.opt_state, mu=self.cut_all(state.opt_state.mu),
            nu=self.cut_all(state.opt_state.nu))
        if state.ema_params is not None:
            state.ema_params = self.cut_all(state.ema_params)
        osc = (state.extra or {}).get("oscillation")
        if osc is not None:
            state.extra = {**state.extra, "oscillation": self.cut_states(osc)}
        state.tp = self
        return state


# ------------------------------------------------------------ the model
def _blocks(model):
    """(name, block) of the model's transformer blocks (Swin's patch
    mergings left out: they stay whole)."""
    return [(n, getattr(model, n)) for n in model.block_names
            if hasattr(getattr(model, n), "attn")]


def _split(blk, parts) -> tuple[bool, bool]:
    """Whether `parts` model ranks cut the block's attention (its heads)
    and its MLP (its hidden units)."""
    return (blk.attn.num_heads % parts == 0,
            blk.mlp.fc1.kernel.shape[1] % parts == 0)


def check_shardable(model: torch.nn.Module, parts: int) -> None:
    """Raise unless `model` is a configuration the port shards over
    `parts` model ranks: NotImplementedError for a frozen artifact (the
    JAX package serves and freezes on one device), ValueError where
    `parts` divides neither a block's heads nor its MLP's hidden
    width."""
    from ..models.deit import VisionTransformer
    from ..models.swin import SwinTransformer
    if not isinstance(model, (VisionTransformer, SwinTransformer)):
        raise TypeError(f"{type(model).__name__}: not a DeiT or Swin model")
    if model.policy.weight_frozen:
        raise NotImplementedError(
            "a frozen artifact is not sharded: the JAX package serves "
            "(Predictor) and freezes (predictor_from_artifact) on one "
            "device, from unsharded parameters (ofq_tpu/serve.py)")
    for name, blk in _blocks(model):
        if not any(_split(blk, parts)):
            raise ValueError(
                f"model_parallel={parts} does not divide {name}'s "
                f"{blk.attn.num_heads} heads or its "
                f"{blk.mlp.fc1.kernel.shape[1]} MLP units")


def _shard_block(name: str, blk, mesh) -> dict:
    """Tell the block's modules their roles; its cuts (`block_cuts`; the
    caller keeps those of the parameters the block has: an unquantized
    site has no shifts or scales)."""
    from ..nn.attention import QAttentionQKR
    from ..nn.linear import PReLU, RPReLU
    parts = mesh.model_parallel
    attn, mlp = blk.attn, blk.mlp
    cut_attn, cut_mlp = _split(blk, parts)
    C, hidden = mlp.fc1.kernel.shape
    H = attn.num_heads
    qkr = isinstance(attn, QAttentionQKR)
    # the tokens of QKR's per-token-and-head scale (none at 32 bits)
    s = getattr(attn, "quan_qkx", None)
    N = 0 if s is None or s.s is None else s.s.shape[0] // H
    lsq = hasattr(mlp.fc1, "weight_quant")
    cuts = block_cuts(name, C, H, N, hidden, parts, qkr=qkr,
                      window=getattr(attn, "window_size", None),
                      attention=cut_attn, mlp=cut_mlp, lsq=lsq,
                      rprelu=isinstance(mlp.act, RPReLU))
    if cut_attn:
        h = H // parts
        attn.num_heads = h
        attn.tp = mesh
        if qkr:
            for b in (attn.move_qkx_b4, attn.move_qkx_aft):
                b.apply_shape = (h, C)
        else:
            attn.qkv.tp = ("col", mesh)
            for q in (getattr(attn, "quan_q", None),
                      getattr(attn, "quan_k", None)):
                if q is not None:
                    q.tp = (2, mesh)              # (B, N, H, d): heads
            for b in (getattr(attn, "move_q_aft", None),
                      getattr(attn, "move_k_aft", None)):
                if b is not None:
                    b.apply_shape = (h, C // H)
        sm = getattr(attn, "quan_softmax", None)
        if sm is not None:
            sm.tp = (1, mesh)                     # (B, H, N, N): heads
        attn.proj.tp = ("row", mesh)
        _row_parallel_input(attn.proj, mesh)
    if cut_mlp:
        mlp.tp = mesh
        mlp.fc1.tp = ("col", mesh)
        mlp.fc2.tp = ("row", mesh)
        _row_parallel_input(mlp.fc2, mesh)
        if isinstance(mlp.act, PReLU):
            # one slope over every column: its partial cotangents summed
            mlp.act.tp = mesh
    return cuts


def _row_parallel_input(linear, mesh) -> None:
    """A row-parallel linear's input scale (its channels cut) and, with
    full-LSQ weights, its weight scale (its rows cut), both whole."""
    iq = getattr(linear, "input_quant", None)
    if iq is not None:
        iq.tp = (-1, mesh)                        # (..., C): channels
    wq = getattr(linear, "weight_quant", None)
    if wq is not None:
        wq.tp = (0, mesh)                         # (in, out): rows


def shard_model(model: torch.nn.Module, mesh) -> Layout:
    """Keep this rank's slices of `model` (calibrated and loaded whole, as
    JAX's runner shards after `model.init`): each sliced parameter is
    replaced by a new one holding this rank's slice, each sharded module
    is told its role (`tp`).  Returns the layout, also `model.tp_layout`."""
    check_shardable(model, mesh.model_parallel)
    if getattr(model, "tp_layout", None) is not None:
        raise ValueError("the model is sharded already")
    params = dict(model.named_parameters())
    cuts = {}
    for name, blk in _blocks(model):
        cuts.update({n: c for n, c in _shard_block(name, blk, mesh).items()
                     if n in params})
    layout = Layout(mesh, cuts)
    with torch.no_grad():
        for n in cuts:
            owner, leaf = n.rsplit(".", 1)
            mod = model.get_submodule(owner)
            old = params[n]
            mod._parameters[leaf] = torch.nn.Parameter(
                layout.cut(n, old.detach()).clone(),
                requires_grad=old.requires_grad)
    model.tp_layout = layout
    return layout
