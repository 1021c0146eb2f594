"""SPMD model-parallel execution of DFG programs (engine scale-out axis 2).

Counterpart of ``repro/core/spmd.py``, planned the same way.  The
engine's planned path runs the post-BatchPre suffix of a DFG on one
device; this module runs that suffix over a (data, model) mesh of device
slots (``launch/mesh.py``) instead:

  * **model axis** — embedding/hidden dims are striped: the activations'
    feature axis and every weight's contracted (row) axis are sharded, each
    slot runs the bound C-kernels (the CUDA kernels or Shell torch) at
    slice shapes, and a ``psum`` at the combine boundary rebuilds the full
    GEMM output *before* the nonlinearity — the Megatron/GShard
    row-parallel split;
  * **data axis** — super-batch destination rows are striped: each slot
    aggregates and transforms its own row block, with a tiled
    ``all_gather`` re-materialising the full activation at each layer
    boundary (the next hop's gather indexes into ALL previous-level rows).

The partition plan, its vocabulary (SpMM*/SDDMM/Prefix/GEMM/BiasAdd/
AggCombine/elementwise), its replicated fallback for ops outside it and
its zero-padding of dims that do not divide the mesh are the reference's.
What differs is the execution of ``shard_map``: one process runs the
body once per slot, in lockstep, each slot over its own env of
contiguous shard tensors on its slot's device (the in_specs applied as
copies, as ``shard_map`` places blocks).  The collectives are tensor
operations across the slots' envs: ``psum`` over the model axis sums the
slots' partials in slot order on each slot's device (so results are
deterministic), the tiled ``all_gather`` concatenates the slots' blocks
onto each slot's device, and ``axis_index`` is the slot's coordinate.
Outputs are reassembled by the out_specs, sliced back to the true
shapes, and returned on slot (0, 0)'s device.  ``jax.eval_shape``'s part
is played by a shape rule for each op of the vocabulary
(:func:`_shape_rule`) and, for an op outside it, by running its kernel
on ``meta`` tensors: nothing runs on a device.

Numerics: ``psum`` re-orders the contraction, so sharded == single-device
at fp32 *allclose* tolerance, not bitwise; a (1, 1) mesh has no
collective and no padding and equals the single device bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F

ROWS_FULL, ROWS_DATA = "full", "data"
FEAT_REP, FEAT_MODEL = "rep", "model"

AGG_OPS = frozenset({"SpMM", "SpMM_Mean", "SpMM_Sum"})
_FUSED_OP = "AggCombine"


class SpmdPlanError(ValueError):
    """The DFG uses a sharded value in a way the plan cannot honor."""


@dataclass(frozen=True)
class VState:
    """Partition state of one value inside the mapped body: how its leading
    (row) axis and trailing (feature) axis relate to the mesh."""
    rows: str = ROWS_FULL       # "full" (replicated) | "data" (row-striped)
    feat: str = FEAT_REP        # "rep" | "model" (feature-striped)


_WEIGHT = VState("wrow", "wrow")      # sentinel: model-striped contracted dim


@dataclass(frozen=True)
class _Slot:
    """One slot of the mesh: its (data, model) coordinate and device."""
    i: int
    j: int
    device: torch.device


def mesh_axes(mesh) -> tuple[str | None, int, str | None, int]:
    """(data_axis, d, model_axis, m) — absent axes behave as size 1."""
    names = tuple(mesh.axis_names)
    sizes = dict(zip(names, mesh.devices.shape))
    da = "data" if "data" in names else None
    ma = "model" if "model" in names else None
    return da, sizes.get("data", 1), ma, sizes.get("model", 1)


def mesh_descriptor(mesh) -> tuple:
    """Hashable mesh identity for the engine's plan cache key."""
    return tuple(zip(mesh.axis_names, mesh.devices.shape))


def _ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _agg_partial_ref(h, nbr, mask, w):
    """torch fallback for the AggCombinePartial C-kernel (mean aggregation —
    the fusion pass only creates mean chains)."""
    g = h[nbr.long()] * mask[..., None]
    s = g.sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)[:, None]
    return s @ w


# --------------------------------------------------------------- input roles
def _classify_inputs(suffix, arr_set: set[str]) -> dict[str, str]:
    """Role per DFG input ref, from how the suffix consumes it:
    h (activations: feature-striped), idx (nbr/mask: row-striped),
    weight (contracted-dim-striped), bias (replicated, width-padded),
    gemm_x (GEMM lhs fed directly: width-padded only)."""
    roles: dict[str, str] = {}

    def mark(ref: str, role: str) -> None:
        if ref not in arr_set:
            return
        prev = roles.get(ref)
        roles[ref] = role if prev in (None, role) else "rep"   # conflict

    for n in suffix:
        if n.op in AGG_OPS or n.op == "SDDMM":
            mark(n.inputs[0], "h")
            mark(n.inputs[1], "idx")
            mark(n.inputs[2], "idx")
        elif n.op == "Prefix":
            mark(n.inputs[0], "h")
            mark(n.inputs[1], "idx")
        elif n.op == "GEMM":
            mark(n.inputs[1], "weight")
            mark(n.inputs[0], "gemm_x")
        elif n.op == _FUSED_OP:
            mark(n.inputs[0], "h")
            mark(n.inputs[1], "idx")
            mark(n.inputs[2], "idx")
            mark(n.inputs[3], "weight")
            mark(n.inputs[4], "bias")
        elif n.op == "BiasAdd":
            mark(n.inputs[1], "bias")
    return roles


def _input_padding(roles, env, arr_refs, d: int, m: int) -> dict[str, tuple]:
    """Zero-padding per input ref so every striped axis divides the mesh.

    Feature/contracted/width dims all pad with the same ``ceil(x/m)*m``
    rule, so matched dims (h cols <-> weight rows, weight cols <-> bias
    width <-> next weight's rows) stay matched; padded columns are exact
    zeros through aggregation, matmul, bias and relu, and outputs are
    sliced back to true widths.  Row-striped idx inputs pad to the data
    axis (nbr pads with index 0 — always valid — under an all-zero mask);
    activations pad their row count up to the largest padded idx row count
    so ``Prefix`` row-slices stay in bounds.
    """
    pads: dict[str, tuple] = {}
    max_dp = 0
    for r in arr_refs:
        if roles.get(r) == "idx":
            max_dp = max(max_dp, _ceil_to(env[r].shape[0], d))
    for r in arr_refs:
        v, role = env[r], roles.get(r)
        if role == "h":
            rows = max(v.shape[0], max_dp)
            p = ((0, rows - v.shape[0]),
                 (0, _ceil_to(v.shape[1], m) - v.shape[1]))
        elif role == "idx":
            p = ((0, _ceil_to(v.shape[0], d) - v.shape[0]), (0, 0))
        elif role == "weight":
            p = ((0, _ceil_to(v.shape[0], m) - v.shape[0]),
                 (0, _ceil_to(v.shape[1], m) - v.shape[1]))
        elif role == "bias":
            p = ((0, _ceil_to(v.shape[0], m) - v.shape[0]),)
        elif role == "gemm_x":
            p = ((0, 0), (0, _ceil_to(v.shape[-1], m) - v.shape[-1]))
        else:
            continue
        if any(hi for _, hi in p):
            pads[r] = p
    return pads


def _pad(v: torch.Tensor, p: tuple) -> torch.Tensor:
    """``jnp.pad(v, p)`` with zeros: ``p`` is ((lo, hi), ...) per dim."""
    return F.pad(v, [x for lo_hi in reversed(p) for x in lo_hi])


def _input_spec(role: str | None, rank: int, da, ma) -> tuple:
    """Mesh axis (or None) that splits each dim, as a PartitionSpec."""
    if role == "h":
        return (None, ma)
    if role == "idx":
        return (da, None)
    if role == "weight":
        return (ma, None)
    return (None,) * rank


def _input_state(role: str | None) -> VState:
    if role == "h":
        return VState(ROWS_FULL, FEAT_MODEL)
    if role == "idx":
        return VState(ROWS_DATA, FEAT_REP)
    if role == "weight":
        return _WEIGHT
    return VState(ROWS_FULL, FEAT_REP)


def _apply(node, fn, args):
    return fn(*args, **node.attrs) if node.attrs else fn(*args)


def _shape_rule(op: str, shapes: list[tuple], attrs: dict):
    """Output shape of a vocabulary op from its inputs' shapes (``()``
    for a scalar), or None for an op outside the vocabulary."""
    if op in AGG_OPS or op == "Prefix":          # (h, nbr, ...) -> (D, F)
        return (shapes[1][0], shapes[0][1])
    if op == "SDDMM":                            # -> (D, K, F)
        return (*shapes[1], shapes[0][1])
    if op == "GEMM":
        return (shapes[0][0], shapes[1][1])
    if op == _FUSED_OP:                          # (h, nbr, mask, w, b)
        return (shapes[1][0], shapes[3][1])
    if op in ("BiasAdd", "ReLU", "LeakyReLU"):
        return shapes[0]
    if op in ("Scale", "Add", "Mul"):
        return tuple(torch.broadcast_shapes(*shapes))
    if op == "DegNorm":
        return (shapes[0][0], 1)
    if op == "Reduce":
        ax = attrs.get("axis", 1) % len(shapes[0])
        return shapes[0][:ax] + shapes[0][ax + 1:]
    return None


# ------------------------------------------------------------- program build
def build_sharded_program(suffix, resolved, arr_refs, static_env,
                          suffix_outs, env, mesh, registry) -> Callable:
    """Lower a DFG suffix onto ``mesh``'s slots.

    Returns a callable over the ``arr_refs``-ordered input tensors (same
    signature as the engine's plain plan walk) that pads inputs to mesh
    divisibility, places each slot's blocks, runs the partitioned body on
    every slot in lockstep, and returns the outputs at the exact
    single-device shapes on slot (0, 0)'s device.
    """
    da, d, ma, m = mesh_axes(mesh)
    sizes = {da: d, ma: m}
    slots = [_Slot(i, j, mesh.devices[i, j]) for i in range(d)
             for j in range(m)]
    arr_set = set(arr_refs)
    roles = _classify_inputs(suffix, arr_set)
    pads = _input_padding(roles, env, arr_refs, d, m)

    # global PADDED shape of every value: shape rules over meta tensors
    # (an op outside the vocabulary runs its kernel on them)
    def _plain(vals):
        e: dict[str, Any] = dict(static_env)
        e.update(zip(arr_refs, vals))
        for node, (_, fn) in zip(suffix, resolved):
            args = [e[i] for i in node.inputs]
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            shape = _shape_rule(node.op, [tuple(getattr(a, "shape", ()))
                                          for a in args], node.attrs)
            if shape is not None and tensors:
                e[node.outputs[0]] = torch.empty(
                    shape, dtype=tensors[0].dtype, device="meta")
                continue
            out = _apply(node, fn, args)
            if len(node.outputs) == 1:
                e[node.outputs[0]] = out
            else:
                e.update(zip(node.outputs, out))
        return {r: tuple(v.shape) for r, v in e.items()
                if isinstance(v, torch.Tensor)}

    def _meta(r, padded: bool):
        shape = list(env[r].shape)
        if padded:
            for ax, (_, hi) in enumerate(pads.get(r, ())):
                shape[ax] += hi
        return torch.empty(shape, dtype=env[r].dtype, device="meta")

    gshape = _plain([_meta(r, True) for r in arr_refs])
    true_shapes = _plain([_meta(r, False) for r in arr_refs])
    true_out = {r: true_shapes[r] for r in suffix_outs}

    states: dict[str, VState] = {r: _input_state(roles.get(r))
                                 for r in arr_refs}
    # a step is ("local", fn(env, slot)) run on every slot, or
    # ("collective", fn(envs)) run once over all slots' envs
    steps: list[tuple[str, Callable]] = []

    def local(fn):
        steps.append(("local", fn))

    # ---- collectives (across the slots' envs, in slot order) -------------
    def _collective(ref, group, combine):
        """Set ``ref`` in every slot to ``combine`` of its group's blocks
        (in slot order) on the slot's device; slots of one group on one
        device share the result."""
        def step(envs):
            done: dict = {}
            outs = []
            for s in slots:
                key = (group(s), s.device)
                if key not in done:
                    done[key] = combine([envs[k][ref].to(s.device)
                                         for k in group(s)])
                outs.append(done[key])
            for e, v in zip(envs, outs):
                e[ref] = v
        steps.append(("collective", step))

    def _model_group(s):
        return tuple(s.i * m + k for k in range(m))

    def _data_group(s):
        return tuple(k * m + s.j for k in range(d))

    def _sum_in_order(parts):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def psum(ref):
        _collective(ref, _model_group, _sum_in_order)

    def gather_rows(ref):
        _collective(ref, _data_group, lambda parts: torch.cat(parts, dim=0))

    def gather_feat(ref):
        _collective(ref, _model_group, lambda parts: torch.cat(parts, dim=-1))

    # ---- slot-local helpers ----------------------------------------------
    def _slice_feat(x, s):
        w = x.shape[-1] // m
        return x.narrow(x.dim() - 1, s.j * w, w).contiguous()

    def _slice_rows(x, loc, s):
        return x.narrow(0, s.i * loc, loc)

    # ---- plan-time normalizers ------------------------------------------
    def full_rows(ref):
        """Ensure ref holds full rows inside the body (gather + store)."""
        st = states[ref]
        if st is _WEIGHT:
            raise SpmdPlanError(f"weight input {ref!r} used as activation")
        if st.rows == ROWS_DATA:
            if d > 1:
                gather_rows(ref)
            states[ref] = VState(ROWS_FULL, st.feat)

    def feat_model_arg(ref):
        """Value -> this shard's feature block; returns an (e, s)->tensor fn."""
        st = states[ref]
        if st.feat == FEAT_MODEL or m == 1:
            return lambda e, s, r=ref: e[r]
        return lambda e, s, r=ref: _slice_feat(e[r], s)

    def rep_everything(ref):
        """Unknown-op fallback: gather to fully replicated."""
        st = states.get(ref)
        if st is None:
            return
        if st is _WEIGHT:
            raise SpmdPlanError(
                f"weight input {ref!r} consumed by an op outside the SPMD "
                "vocabulary — cannot replicate a contracted-dim shard")
        full_rows(ref)
        if states[ref].feat == FEAT_MODEL:
            if m > 1:
                gather_feat(ref)
            states[ref] = VState(states[ref].rows, FEAT_REP)

    def assign(e, node, out):
        """Bind a node's output(s) into a slot's env."""
        if len(node.outputs) == 1:
            e[node.outputs[0]] = out
        else:
            e.update(zip(node.outputs, out))

    # ---- per-node planning ----------------------------------------------
    for node, (dev, fn) in zip(suffix, resolved):
        op, ins = node.op, node.inputs

        if op in AGG_OPS:
            h, nbr, mask = ins
            full_rows(h)
            get_h = feat_model_arg(h)
            local(lambda e, s, n=node, f=fn, g=get_h, nb=nbr, mk=mask:
                  e.__setitem__(n.outputs[0], f(g(e, s), e[nb], e[mk])))
            states[node.outputs[0]] = VState(states[nbr].rows, FEAT_MODEL)

        elif op == "SDDMM":
            h, nbr, mask = ins
            full_rows(h)
            get_h = feat_model_arg(h)
            if states[nbr].rows == ROWS_DATA and d > 1:
                # the kernel pairs dst rows with h[:D]; under row striping
                # slot i's dst rows live at offset i*loc — shard-aware torch
                # in sddmm_ref's order of products
                def _sddmm_step(e, s, n=node, g=get_h, nb=nbr, mk=mask):
                    hh, nv, mv = g(e, s), e[nb], e[mk]
                    selfh = _slice_rows(hh, nv.shape[0], s)
                    gath = hh.index_select(0, nv.reshape(-1).long()).view(
                        *nv.shape, -1)
                    e[n.outputs[0]] = (gath * selfh[:, None, :]
                                       * mv[..., None])
                local(_sddmm_step)
            else:
                local(lambda e, s, n=node, f=fn, g=get_h, nb=nbr, mk=mask:
                      e.__setitem__(n.outputs[0], f(g(e, s), e[nb], e[mk])))
            states[node.outputs[0]] = VState(states[nbr].rows, FEAT_MODEL)

        elif op == "Prefix":
            h, nbr = ins
            full_rows(h)
            hfeat = states[h].feat
            if states[nbr].rows == ROWS_DATA and d > 1:
                local(lambda e, s, n=node, hr=h, nb=nbr: e.__setitem__(
                    n.outputs[0], _slice_rows(e[hr], e[nb].shape[0], s)))
            else:
                local(lambda e, s, n=node, f=fn, hr=h, nb=nbr:
                      e.__setitem__(n.outputs[0], f(e[hr], e[nb])))
            states[node.outputs[0]] = VState(states[nbr].rows, hfeat)

        elif op == "GEMM" and states.get(ins[1]) is _WEIGHT:
            x, w = ins
            get_x = feat_model_arg(x)
            local(lambda e, s, n=node, f=fn, g=get_x, wr=w: e.__setitem__(
                n.outputs[0], f(g(e, s), e[wr])))
            if m > 1:
                psum(node.outputs[0])
            states[node.outputs[0]] = VState(states[x].rows, FEAT_REP)

        elif op == _FUSED_OP and states.get(ins[3]) is _WEIGHT:
            h, nbr, mask, w, b = ins
            full_rows(h)
            get_h = feat_model_arg(h)
            try:
                _, pfn = registry.resolve("AggCombinePartial")
            except KeyError:
                pfn = _agg_partial_ref
            out = node.outputs[0]
            local(lambda e, s, pf=pfn, g=get_h, nb=nbr, mk=mask, wr=w, o=out:
                  e.__setitem__(o, pf(g(e, s), e[nb], e[mk], e[wr])))
            if m > 1:
                psum(out)
            local(lambda e, s, br=b, o=out: e.__setitem__(
                o, torch.relu(e[o] + e[br])))
            states[out] = VState(states[nbr].rows, FEAT_REP)

        elif op == "BiasAdd":
            x, b = ins
            sx = states[x]
            get_b = (feat_model_arg(b) if sx.feat == FEAT_MODEL
                     else (lambda e, s, r=b: e[r]))
            local(lambda e, s, n=node, f=fn, xr=x, g=get_b:
                  e.__setitem__(n.outputs[0], f(e[xr], g(e, s))))
            states[node.outputs[0]] = sx

        elif op in ("ReLU", "LeakyReLU", "Scale"):
            local(lambda e, s, n=node, f=fn: e.__setitem__(
                n.outputs[0], _apply(n, f, [e[i] for i in n.inputs])))
            states[node.outputs[0]] = states.get(ins[0], VState())

        elif op == "DegNorm":
            local(lambda e, s, n=node, f=fn: e.__setitem__(
                n.outputs[0], f(e[n.inputs[0]])))
            states[node.outputs[0]] = VState(
                states.get(ins[0], VState()).rows, FEAT_REP)

        elif op == "Reduce":
            x = ins[0]
            ndim = len(gshape[x])
            ax = node.attrs.get("axis", 1) % ndim
            if ax == 0:
                full_rows(x)
            if ax == ndim - 1:
                rep_everything(x)
            local(lambda e, s, n=node, f=fn: e.__setitem__(
                n.outputs[0], f(e[n.inputs[0]], **n.attrs)))
            states[node.outputs[0]] = states[x]

        elif op in ("Add", "Mul"):
            x, y = ins
            sx = states.get(x, VState())
            sy = states.get(y, VState())
            if _WEIGHT in (sx, sy):
                raise SpmdPlanError(f"weight input consumed by {op}")
            gx, gy = gshape.get(x), gshape.get(y)
            getx = lambda e, s, r=x: e[r]          # noqa: E731
            gety = lambda e, s, r=y: e[r]          # noqa: E731
            # unify rows: row-slice the replicated side (leading dims match)
            rows = ROWS_FULL
            if sx.rows == ROWS_DATA or sy.rows == ROWS_DATA:
                rows = ROWS_DATA
                if sx.rows != ROWS_DATA and len(gx) >= 1 and d > 1:
                    getx = lambda e, s, r=x, lc=gx[0] // d: _slice_rows(e[r], lc, s)  # noqa: E731,E501
                if sy.rows != ROWS_DATA and len(gy) >= 1 and d > 1:
                    gety = lambda e, s, r=y, lc=gy[0] // d: _slice_rows(e[r], lc, s)  # noqa: E731,E501
            # unify feat: feature-slice the replicated side unless it
            # broadcasts (trailing width 1 / lower rank)
            feat = FEAT_REP
            if sx.feat == FEAT_MODEL or sy.feat == FEAT_MODEL:
                feat = FEAT_MODEL
                if sx.feat != FEAT_MODEL and gx and gx[-1] != 1 and m > 1:
                    getx = (lambda e, s, g0=getx: _slice_feat(g0(e, s), s))
                if sy.feat != FEAT_MODEL and gy and gy[-1] != 1 and m > 1:
                    gety = (lambda e, s, g0=gety: _slice_feat(g0(e, s), s))
            local(lambda e, s, n=node, f=fn, g1=getx, g2=gety:
                  e.__setitem__(n.outputs[0], f(g1(e, s), g2(e, s))))
            states[node.outputs[0]] = VState(rows, feat)

        else:
            # outside the SPMD vocabulary: run fully replicated
            for i in ins:
                rep_everything(i)
            local(lambda e, s, n=node, f=fn: assign(
                e, n, _apply(n, f, [e[i] for i in n.inputs])))
            for o in node.outputs:
                states[o] = VState()

    # ---- output specs (the slots' blocks reassembled) ---------------------
    out_specs = []
    for r in suffix_outs:
        st, rank = states[r], len(gshape[r])
        if st is _WEIGHT:
            raise SpmdPlanError(f"DFG output {r!r} is a weight input")
        if rank < 2 and (st.rows == ROWS_DATA or st.feat == FEAT_MODEL):
            rep_everything(r)
            st = states[r]
        out_specs.append((st.rows == ROWS_DATA and rank >= 2,
                          st.feat == FEAT_MODEL and rank >= 2))

    in_specs = [_input_spec(roles.get(r), len(env[r].shape), da, ma)
                for r in arr_refs]

    def place(v, spec, s):
        """Slot ``s``'s block of input ``v`` under ``spec``: a contiguous
        copy on the slot's device where an axis splits it."""
        blk = v
        for dim, ax in enumerate(spec):
            if ax is not None and sizes[ax] > 1:
                w = v.shape[dim] // sizes[ax]
                blk = blk.narrow(dim, (s.i if ax == da else s.j) * w, w)
        if blk is v:
            return v.to(s.device)
        return blk.to(s.device, copy=True,
                      memory_format=torch.contiguous_format)

    def assemble(envs, r, by_rows, by_feat):
        """A global output from the slots' blocks, on slot (0, 0)'s
        device: concatenated along each axis that stripes it."""
        home = slots[0].device
        row_blocks = []
        for i in range(d if by_rows else 1):
            cols = [envs[i * m + j][r].to(home)
                    for j in range(m if by_feat else 1)]
            row_blocks.append(cols[0] if len(cols) == 1
                              else torch.cat(cols, dim=-1))
        return (row_blocks[0] if len(row_blocks) == 1
                else torch.cat(row_blocks, dim=0))

    def program(*vals):
        padded = [_pad(v, pads[r]) if r in pads else v
                  for r, v in zip(arr_refs, vals)]
        envs = []
        for s in slots:
            e: dict[str, Any] = dict(static_env)
            e.update((r, place(v, spec, s))
                     for r, v, spec in zip(arr_refs, padded, in_specs))
            envs.append(e)
        for kind, step in steps:
            if kind == "local":
                for e, s in zip(envs, slots):
                    step(e, s)
            else:
                step(envs)
        outs = []
        for r, (by_rows, by_feat) in zip(suffix_outs, out_specs):
            o = assemble(envs, r, by_rows, by_feat)
            if tuple(o.shape) != tuple(true_out[r]):
                o = o[tuple(slice(0, n) for n in true_out[r])]
            outs.append(o)
        return tuple(outs)

    return program
