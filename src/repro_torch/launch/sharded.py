"""The dry run's DTensor forms of the model's device-local work.

The model's layers (``models.layers``, ``models.ssm``) hold one plain path
and the reference's constraint points (``layers.constrain``). Some of
their work DTensor cannot partition by its own rules, or partitions
differently from one torch release to another: the MoE's routing (a
stable sort, a sorted search, scatters) and its experts' einsums, the
sLSTM's time loop and the chunked scan, pads, the loss over a
vocabulary-sharded logits tensor, a decode step's write of its token
into the cache, its softmax over the cache's slots and its merges of
heads. That work mixes nothing across
the rows and heads that the devices hold, so the reference's compiler
partitions it by those rows and heads; here it runs through
``local_map`` on each device's own shards, with no collective inside it.

:func:`local_forms` swaps these forms into the layers for a counted step
on a mesh and puts the plain functions back after it;
:func:`dtensor_patches` changes three pieces of DTensor itself for the
count. Nothing here runs outside the dry run.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

from repro_torch.models import layers as L
from repro_torch.models import ssm


def _is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh")


def _tp_axis() -> str:
    ctx = L._ACT_CTX.get()
    return ctx.tp if ctx is not None else "model"


# ---------------------------------------------------------------------------
# Seams of the layers
# ---------------------------------------------------------------------------

def shardwise(fn, x, dims):
    """``layers.shardwise`` on a DTensor: ``x`` first gathered along
    ``dims`` where a mesh dimension shards them, then ``fn`` on each
    device's shard. DTensor's own rules for such operations differ between
    torch releases (a pad's redistribution raises an IndexError in torch
    2.11; a cumulative sum's backward ``flip`` has no rule there)."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    own = {d % x.dim() for d in dims}
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() in own
          else p for p in x.placements]
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def batch_sharded(t):
    """``layers.batch_sharded`` on a DTensor: ``t`` held whole on every
    mesh dimension but those that shard its first (batch) dimension. Some
    torch releases cannot merge a sharded dimension into one before it
    (torch 2.11 raises where 2.13 makes a strided shard), and a decode
    step's activations are one token a row."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    return t.redistribute(t.device_mesh, [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in t.placements])


def write_slot(cache, pos: int, val):
    """``layers.write_slot`` on a DTensor cache: each device writes the
    token into its own shard, as the reference's compiler partitions its
    ``dynamic_update_slice`` (DTensor's rule for a slice assignment
    gathers the cache). ``val`` (the cache without its slot dimension)
    goes to the cache's shards: sharded like the cache's batch and
    trailing dimensions, whole over the mesh dimension that shards the
    slots. The count is the device's that holds slot ``pos``; the others
    write nothing."""
    if not _is_dtensor(cache):
        cache[:, pos] = val.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    c_pl = list(cache.placements)
    v_pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
            else p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in c_pl]

    def write(c, v):
        c[:, pos % c.shape[1]] = v.to(c.dtype)
        return c

    local_map(write, out_placements=c_pl, in_placements=(c_pl, v_pl),
              device_mesh=cache.device_mesh,
              redistribute_inputs=True)(cache, val)


def slot_softmax(scores):
    """``layers.slot_softmax`` on DTensor scores sharded over the cache's
    slots: each device's exponentials of its own slots, their maximum and
    sum all-reduced over the mesh dimensions that shard the slots (the
    reference's compiler partitions the masked softmax the same way;
    DTensor's rule gathers the scores)."""
    from torch.distributed.tensor import Shard

    last = scores.dim() - 1 if _is_dtensor(scores) else None
    dims = [i for i, p in enumerate(getattr(scores, "placements", ()))
            if isinstance(p, Shard) and p.dim % scores.dim() == last]
    if not dims:
        return torch.softmax(scores, dim=-1)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    mesh = scores.device_mesh
    groups = [mesh.get_group(i) for i in dims]

    def softmax(s):
        top = s.amax(-1, keepdim=True)
        for g in groups:
            top = funcol.all_reduce(top, "max", g)
        e = torch.exp(s - top)
        total = e.sum(-1, keepdim=True)
        for g in groups:
            total = funcol.all_reduce(total, "sum", g)
        return e / total

    pl = list(scores.placements)
    return local_map(softmax, out_placements=pl, in_placements=(pl,),
                     device_mesh=mesh, redistribute_inputs=True)(scores)


def group_local(fn, groups, n_out: int, *shared):
    """``fn(groups, *shared)`` run on each device's own rows: ``groups`` (a
    DTensor or a tuple of them, each (G, ...)) with dimension 0 sharded
    over the mesh dimensions that shard it now and replicated over the
    others, ``shared`` replicated (their gradients summed over the devices
    of the rows). ``n_out``: ``fn``'s output tensors, each group-sharded:
    one tensor, or a tensor and a tuple of ``n_out - 1``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    many = isinstance(groups, tuple)
    flat = list(groups) if many else [groups]
    mesh = flat[0].device_mesh
    # a placement sequence is a list: local_map reads a tuple as one
    # sequence an output
    grp = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0
           else Replicate() for pl in flat[0].placements]
    rep = [Replicate()] * mesh.ndim
    # a shared weight's gradient: each device's groups' share, summed
    summed = [Partial() if isinstance(pl, Shard) else pl for pl in grp]

    def call(*args):
        gs, rest = args[:len(flat)], args[len(flat):]
        out = fn(tuple(gs) if many else gs[0], *rest)
        if isinstance(out, tuple):      # (tensor, tuple of tensors)
            return (out[0],) + tuple(out[1])
        return out

    out = local_map(call, out_placements=(grp,) * n_out if n_out > 1
                    else grp,
                    in_placements=(grp,) * len(flat) + (rep,) * len(shared),
                    in_grad_placements=((grp,) * len(flat)
                                        + (summed,) * len(shared)),
                    device_mesh=mesh, redistribute_inputs=True)(
        *flat, *shared)
    return (out[0], tuple(out[1:])) if n_out > 1 else out


# ---------------------------------------------------------------------------
# The MoE: routing, experts and combine, each device on its own groups
# ---------------------------------------------------------------------------

def _moe_dispatch(plain):
    def dispatch(cfg, p, xt, cap):
        if not _is_dtensor(xt):
            return plain(cfg, p, xt, cap)
        return group_local(
            lambda xg, w: plain(
                cfg, SimpleNamespace(router=SimpleNamespace(w=w)), xg, cap),
            xt, 7, p.router.w)
    return dispatch


def _expert_ffn(plain):
    def experts(disp, w_gate, w_in, w_out):
        """Each device on its own groups and experts: the expert banks
        gathered over the mesh dimensions that shard the groups (their
        gradients summed back over them), sharded like the buffer's expert
        dimension elsewhere. DTensor runs the einsums' views on local
        shards it cannot view."""
        if not _is_dtensor(disp):
            return plain(disp, w_gate, w_in, w_out)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        w_pl, w_grad = [], []
        for pl in disp.placements:
            if isinstance(pl, Shard) and pl.dim == 0:
                w_pl.append(Replicate())
                w_grad.append(Partial())
            elif isinstance(pl, Shard) and pl.dim == 1:
                w_pl.append(Shard(0))
                w_grad.append(Shard(0))
            else:
                w_pl.append(Replicate())
                w_grad.append(Replicate())
        d = list(disp.placements)
        return local_map(plain, out_placements=d,
                         in_placements=(d, w_pl, w_pl, w_pl),
                         in_grad_placements=(d, w_grad, w_grad, w_grad),
                         device_mesh=disp.device_mesh,
                         redistribute_inputs=True)(disp, w_gate, w_in, w_out)
    return experts


def _moe_combine(plain):
    def combine(meta, out, tg, cap):
        # each device combines its own groups, their expert outputs
        # gathered over the experts' axis (the return all-to-all)
        if not _is_dtensor(out):
            return plain(meta, out, tg, cap)
        return group_local(lambda gs: plain(gs[:-1], gs[-1], tg, cap),
                           tuple(meta) + (out,), 1)
    return combine


# ---------------------------------------------------------------------------
# The recurrent families: the chunked scan and the sLSTM's time loop
# ---------------------------------------------------------------------------

def _chunked_scan(plain):
    def scan(q, k, v, decay, chunk):
        """Each device on its own rows (over the batch axes, where they
        divide the batch) and heads (over the tensor axis, where it
        divides them): the scan mixes neither. Shared q/k (SSD's B/C) are
        held whole over the tensor axis, their gradients summed over it."""
        if not _is_dtensor(v):
            return plain(q, k, v, decay, chunk)
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map

        mesh = v.device_mesh
        tp = _tp_axis()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        dp = [n for n in mesh.mesh_dim_names if n != tp]
        b, _, h, _ = v.shape
        rows = b % int(np.prod([sizes[n] for n in dp])) == 0
        heads = h % sizes.get(tp, 1) == 0
        per_head = q.dim() == 4

        def place(head_dim, grad=False):
            out = []
            for n in mesh.mesh_dim_names:
                if n == tp:
                    out.append(Shard(head_dim) if heads and head_dim is not None
                               else Partial() if grad and heads
                               else Replicate())
                else:
                    out.append(Shard(0) if rows else Replicate())
            return out

        qk = place(2 if per_head else None)
        qk_grad = place(2 if per_head else None, grad=True)
        hv = place(2)
        return local_map(
            lambda *a: plain(*a, chunk),
            out_placements=hv, in_placements=(qk, qk, hv, hv),
            in_grad_placements=(qk_grad, qk_grad, hv, hv), device_mesh=mesh,
            redistribute_inputs=True)(q, k, v, decay)
    return scan


def _slstm_scan(plain):
    def scan(pre_all, r):
        # each device's rows through the loop as plain tensors: DTensor
        # dispatches the loop's ~250 operations a step slowly
        if not _is_dtensor(pre_all):
            return plain(pre_all, r)
        return group_local(plain, pre_all, 1, r)
    return scan


# ---------------------------------------------------------------------------
# The loss over vocabulary-sharded logits
# ---------------------------------------------------------------------------

def _next_token_loss(plain):
    def loss(logits, labels, skip: int = 0):
        """The same function in a form that DTensor shards (inside torch's
        ``loss_parallel``): the logits sharded over the vocabulary on the
        tensor axis and over the batch on the others, each device reducing
        its own columns of its own rows, and the positions without a label
        masked out of the targets (index -100) instead of sliced out of the
        logits (the slice would gather them). ``loss_parallel`` takes a
        one-dimensional mesh in torch 2.11, so each device's rows go to it
        as a DTensor on the tensor axis alone, and the devices' sums are
        summed over the batch axes after it."""
        if not _is_dtensor(logits):
            return plain(logits, labels, skip)
        from torch.distributed.tensor import (
            DTensor, Partial, Replicate, Shard)

        tp = _tp_axis()
        mesh = logits.device_mesh
        names = mesh.mesh_dim_names
        rows = [Replicate() if name == tp else Shard(0) for name in names]
        lf = logits.float().redistribute(mesh, [
            Shard(logits.dim() - 1) if name == tp else Shard(0)
            for name in names])
        b, s = labels.shape
        lab = labels.redistribute(mesh, rows).to_local()
        bl = lab.shape[0]
        target = torch.cat([torch.full((bl, skip), -100, dtype=lab.dtype),
                            lab[:, 1:],
                            torch.full((bl, 1), -100, dtype=lab.dtype)], dim=1)
        sub = mesh[tp]
        v = lf.shape[-1]
        mine = DTensor.from_local(
            lf.to_local(grad_placements=lf.placements), sub, [Shard(2)],
            run_check=False, shape=(bl,) + tuple(lf.shape[1:]),
            stride=(lf.shape[1] * v, v, 1))
        part = torch.nn.functional.cross_entropy(
            mine.reshape(-1, v), target.reshape(-1).long(), ignore_index=-100,
            reduction="sum")
        total = DTensor.from_local(
            part.to_local(), mesh,
            [Replicate() if name == tp else Partial() for name in names],
            run_check=False, shape=(), stride=())
        return total.redistribute(mesh, [Replicate()] * mesh.ndim) / (
            b * (s - 1))
    return loss


#: (module, name, the DTensor form's maker, which takes the plain function)
_FORMS = (
    (L, "shardwise", lambda plain: shardwise),
    (ssm, "shardwise", lambda plain: shardwise),
    (L, "batch_sharded", lambda plain: batch_sharded),
    (L, "write_slot", lambda plain: write_slot),
    (L, "slot_softmax", lambda plain: slot_softmax),
    (ssm, "batch_sharded", lambda plain: batch_sharded),
    (L, "_moe_dispatch", _moe_dispatch),
    (L, "_expert_ffn", _expert_ffn),
    (L, "_moe_combine", _moe_combine),
    (L, "next_token_loss", _next_token_loss),
    (ssm, "chunked_linear_attention", _chunked_scan),
    (ssm, "_slstm_scan", _slstm_scan),
)


@contextlib.contextmanager
def local_forms():
    """The DTensor forms above in place of the layers' plain functions for
    a block (each falls back to the plain function on a plain tensor)."""
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in _FORMS]
    for (mod, name, make), (_, _, plain) in zip(_FORMS, old):
        setattr(mod, name, make(plain))
    try:
        yield
    finally:
        for mod, name, plain in old:
            setattr(mod, name, plain)


# ---------------------------------------------------------------------------
# DTensor itself, for a counted step
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def dtensor_patches(counter):
    """Three changes to DTensor for a step counted by ``counter`` (a
    ``roofline.counter.StepCounter``), undone after it (each only where
    this torch has the piece it changes):

    * DTensor chooses an operation's sharding, and infers its global
      output shape, by running the operation (or its decomposition) on
      global-shaped fake tensors: those shadow runs are no device's work,
      so they run outside the counter's mode (in a fake mode of their own)
      and the counter is muted during them, as it is while a strided
      shard computes its local size and offset from index tensors (a
      function of integers, memoised);
    * on a CPU mesh DTensor moves a shard from one dimension to another by
      an all-gather and a chunk (gloo has no all-to-all); a fake group has
      the all-to-all operation itself, so the move takes it, as it does on
      a CUDA mesh."""
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def muted(fn):
        def call(*args, **kwargs):
            counter._muted += 1
            try:
                # outside the counter's mode: DTensor's planning also runs
                # small real tensors (mesh coordinates), which must stay real
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter._muted -= 1
        return call

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        name = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, name)

    strided = getattr(pt, "_StridedShard", None)
    memo = {}

    def memoised(fn):
        plain = muted(fn)

        def call(self, *args, **kwargs):
            key = (self.dim, self.split_factor,
                   tuple(int(a) if isinstance(a, (int, torch.SymInt)) else a
                         for a in args), tuple(sorted(kwargs.items())))
            if key not in memo:
                memo[key] = plain(self, *args, **kwargs)
            return memo[key]
        return call

    patches = [(ShardingPropagator, n, muted) for n in (
        "_propagate_tensor_meta_non_cached",
        "propagate_op_sharding_non_cached")]
    if hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        patches.append((pt, "shard_dim_alltoall", lambda fn: alltoall))
    if strided is not None:
        patches.append((strided, "local_shard_size_and_offset", memoised))
    old = [(obj, n, getattr(obj, n)) for obj, n, _ in patches
           if hasattr(obj, n)]
    for (obj, n, wrap), (_, _, fn) in zip(
            [p for p in patches if hasattr(p[0], p[1])], old):
        setattr(obj, n, wrap(fn))
    try:
        yield
    finally:
        for obj, n, fn in old:
            setattr(obj, n, fn)
