"""The lane axis: one plan run for a batched-dispatch tick of G queries.

The JAX package's batched program is ``jax.vmap`` of the compiled plan
(``baikaldb_tpu/exec/dispatch.py``): every lane evaluates the plan with its
own params, only the operations that depend on a param are batched, and a
``pallas_call`` under ``vmap`` becomes one launch with a lane grid axis.
This module is the explicit counterpart for the eager executor:

- a ``Param`` evaluates to a ``[G, 1]`` tensor (expr/params.py), so a
  comparison against an ``[n]`` column gives a ``[G, n]`` mask, and
  everything that depends on no param is computed once; a slot every lane
  binds to the same value binds as that one value, so in ``v*2+1 > ?``
  (three hoisted literals, the 2 and the 1 the same in every lane) only
  the comparison is per lane.  A WHERE's top-level AND terms fold
  into the selection one at a time, so a tick holds one ``[G, n]``
  temporary per term, not the Kleene AND's six;
- a filter ANDs its mask into the lanes' selection, ``sel`` of shape
  ``[G, n]`` (or ``[n]`` while no param touched it);
- a dense GROUP BY runs ``ops/hashagg.group_aggregate_dense_lanes``: the
  segment kernel under the gate, K3 + K1/K2 above it, each launched ONCE
  over all lanes; a scalar aggregate runs the one-lane function per lane
  (torch reductions, no host sync), so its float sums keep the serial
  run's reduction order;
- the per-lane egress compact (``gather_live``) takes each lane's first
  ``cap`` live rows in row order on the device, and the tick's outputs
  leave in ONE device-to-host transfer; ``rebuild_clients`` slices each
  client's host batch out of it, bit-identical to the serial
  ``_egress_compact``.

What the lowering covers: Scan (with its pushed filter), Filter, Project,
Shrink and Agg (scalar, or dense over param-free keys and inputs, of
COUNT / COUNT(*) / SUM / AVG / MIN / MAX without DISTINCT), off the mesh.
``LaneProgram`` checks the plan when it is built, before any launch, and
raises ``CombineFallback`` (the dispatcher's valve) for anything else.
There are no per-lane host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..column.batch import Column, ColumnBatch
from ..expr.ast import ColRef, Param
from ..expr.compile import eval_output, eval_predicate
from ..expr.params import bind_params
from ..ops.hashagg import LANE_AGGS, group_aggregate_dense_lanes, scalar_aggregate
from ..plan.eqclasses import conjuncts
from ..plan.nodes import (AggNode, FilterNode, PlanNode, ProjectNode, ScanNode,
                          ShrinkNode)
from .dispatch import CombineFallback
from .executor import _broadcast, _shift_keys, device_params


@dataclass
class LaneBatch(ColumnBatch):
    """A batch of ``rows`` rows seen by ``lanes`` lanes: a column's data is
    ``[rows]`` (shared) or ``[lanes, rows]``; ``sel`` is None, ``[rows]`` or
    ``[lanes, rows]``.  ``len()`` is the row count, what the expression
    compiler broadcasts constants to."""

    rows: int = 0
    lanes: int = 1

    def __len__(self) -> int:
        return self.rows


def _refs(e) -> set:
    """Column names an expression reads."""
    out, stack = set(), [e]
    while stack:
        x = stack.pop()
        if isinstance(x, ColRef):
            out.add(x.name)
        stack.extend(getattr(x, "args", ()) or ())
    return out


def _has_param(e) -> bool:
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, Param):
            return True
        stack.extend(getattr(x, "args", ()) or ())
    return False


class LaneProgram:
    """The lane lowering of one plan; building it checks the plan (raising
    ``CombineFallback`` for what the lowering cannot express), ``run``
    evaluates it for a tick."""

    def __init__(self, plan: PlanNode, device):
        self.plan = plan
        self.device = torch.device(device)
        self._check(plan)

    def _check(self, node: PlanNode) -> set:
        """-> the node's output columns whose values depend on a param;
        raises ``CombineFallback`` on anything the lowering lacks."""
        if isinstance(node, ScanNode):
            if node.ann is not None:
                raise CombineFallback("an ANN scan")
            return set()
        kids = [self._check(c) for c in node.children]
        if isinstance(node, (FilterNode, ShrinkNode)):
            return kids[0]
        if isinstance(node, ProjectNode) and not node.derived:
            return {name for name, e in zip(node.names, node.exprs)
                    if _has_param(e) or _refs(e) & kids[0]}
        if isinstance(node, AggNode) and not getattr(node, "merge", False):
            for s in node.specs:
                if s.op not in LANE_AGGS or s.distinct:
                    raise CombineFallback(f"aggregate {s.op} on the lane axis")
                if s.input is not None and s.input in kids[0]:
                    raise CombineFallback("an aggregate input that depends on a param")
            if node.key_names:
                if node.strategy != "dense":
                    raise CombineFallback("a sorted GROUP BY on the lane axis")
                if set(node.key_names) & kids[0]:
                    raise CombineFallback("a GROUP BY key that depends on a param")
            return set()
        raise CombineFallback(f"{type(node).__name__} on the lane axis")

    def run(self, batches: dict, params: tuple, cap: int):
        """One tick: ``params`` the stacked slots (numpy ``[G, 1]`` scalars
        or ``[G, 2]`` strcmp bounds) -> the packed outputs of every lane's
        egress compact (``gather_live``), still on the device."""
        G = int(params[0].shape[0]) if params else 1
        with bind_params(device_params([_lane_slot(p) for p in params], self.device)):
            out = self._eval(self.plan, batches, G)
        return gather_live(out, cap)

    # -- evaluation ------------------------------------------------------
    def _eval(self, node: PlanNode, batches: dict, G: int) -> LaneBatch:
        if isinstance(node, ScanNode):
            b = batches[node.table_key]
            names = tuple(f"{node.label}.{c}" for c in node.columns)
            sel = b.sel
            if b.num_rows is not None:
                sel = torch.arange(len(b), device=b.device) < b.num_rows
            out = LaneBatch(names, [b.column(c) for c in node.columns], sel, None,
                            device=b.device, rows=len(b), lanes=G)
            if node.pushed_filter is not None:
                out = _filter(out, node.pushed_filter)
            return out
        child = self._eval(node.children[0], batches, G)
        if isinstance(node, ShrinkNode):
            return child
        if isinstance(node, FilterNode):
            return _filter(child, node.pred)
        if isinstance(node, ProjectNode):
            cols = [_broadcast(eval_output(e, child), child.rows) for e in node.exprs]
            return LaneBatch(tuple(node.names), cols, child.sel, None, device=child.device,
                             rows=child.rows, lanes=G)
        return self._agg(node, child, G)

    def _agg(self, node: AggNode, child: LaneBatch, G: int) -> LaneBatch:
        sel = _lane_sel(child)
        if not node.key_names:
            # the one-lane function per lane: the serial reduction order
            outs = [scalar_aggregate(_lane_view(child, sel, g), node.specs) for g in range(G)]
            cols = [Column(torch.stack([o.columns[i].data for o in outs]),
                           None if outs[0].columns[i].validity is None else
                           torch.stack([o.columns[i].validity for o in outs]),
                           c.ltype, c.dictionary)
                    for i, c in enumerate(outs[0].columns)]
            return LaneBatch(outs[0].names, cols, None, None, device=child.device, rows=1,
                             lanes=G)
        shift = getattr(node, "key_shift", {}) or {}
        work = _shift_keys(child, shift, -1) if shift else child
        names, cols, present = group_aggregate_dense_lanes(work, node.key_names, node.domains,
                                                           node.specs, sel)
        out = LaneBatch(tuple(names), cols, present, None, device=child.device,
                        rows=present.shape[1], lanes=G)
        return _shift_keys(out, shift, 1) if shift else out


def _lane_slot(p: np.ndarray) -> np.ndarray:
    """A stacked param slot as bound: its one value when every lane holds
    the same (the 2 and 1 of ``v*2+1 > ?``: the arithmetic then runs once,
    as in a serial run, and only the comparison is per lane), else the
    [G, 1] (strcmp: [G, 2]) stack."""
    if (p == p[:1]).all():
        return p[0] if p.shape[1] > 1 else p[0, 0]
    return p


def _filter(b: LaneBatch, pred) -> LaneBatch:
    """AND ``pred`` into the lanes' selection, one top-level AND term at a
    time (a row passes a Kleene AND iff it passes every term)."""
    sel = b.sel
    for term in conjuncts(pred):
        m = eval_predicate(term, b)
        sel = m if sel is None else sel & m
    return replace(b, sel=sel)


def _lane_sel(b: LaneBatch) -> torch.Tensor:
    """The selection as a contiguous bool [G, rows]."""
    if b.sel is None:
        return torch.ones((b.lanes, b.rows), dtype=torch.bool, device=b.device)
    if b.sel.ndim == 1:
        return b.sel.expand(b.lanes, b.rows).contiguous()
    return b.sel.contiguous()


def _lane_view(b: LaneBatch, sel, g: int) -> ColumnBatch:
    """Lane ``g`` as a one-lane batch."""
    cols = [replace(c, data=c.data[g] if c.data.ndim == 2 else c.data,
                    validity=c.validity[g] if c.validity is not None and c.validity.ndim == 2
                    else c.validity) for c in b.columns]
    return ColumnBatch(b.names, cols, sel[g], None, device=b.device)


# -- the scatter-back ----------------------------------------------------------

@dataclass
class Packed:
    """A tick's outputs in one device buffer, and how to read it back."""

    buf: torch.Tensor           # uint8, every tensor's bytes end to end
    parts: list                 # (offset, nbytes, dtype, shape) a tensor
    names: tuple
    colmeta: tuple              # (ltype, dictionary, has_validity) a column
    cap: int                    # rows gathered a lane


def gather_live(b: LaneBatch, cap: int) -> Packed:
    """Each lane's first ``cap`` live rows, in row order (the rows the
    serial ``_egress_compact`` keeps, when a lane has at most ``cap``), and
    its live count, packed into one uint8 buffer on the device."""
    G, m = b.lanes, b.rows
    dev = b.device
    k = min(max(1, int(cap)), m)
    if b.sel is None or m == 0:
        idx = torch.arange(k, device=dev).expand(G, k)
        ns = torch.full((G,), m, dtype=torch.int64, device=dev)
    else:
        cs = torch.cumsum(_lane_sel(b).to(torch.int32), dim=1)
        ns = cs[:, -1].to(torch.int64)
        want = torch.arange(1, k + 1, dtype=torch.int32, device=dev).expand(G, k).contiguous()
        idx = torch.searchsorted(cs, want).clamp(0, m - 1)

    def take(t):
        return torch.gather(t, 1, idx) if t.ndim == 2 else t[idx]

    tensors = [ns]
    for c in b.columns:
        tensors.append(take(_broadcast(c, m).data))
        if c.validity is not None:
            tensors.append(take(_broadcast(c, m).validity))
    parts, pieces, off = [], [], 0
    for t in tensors:
        t = t.contiguous()
        nb = t.numel() * t.element_size()
        parts.append((off, nb, t.dtype, tuple(t.shape)))
        pieces.append(t.reshape(-1).view(torch.uint8))
        off += nb
    buf = torch.cat(pieces) if pieces else torch.zeros(0, dtype=torch.uint8, device=dev)
    meta = tuple((c.ltype, c.dictionary, c.validity is not None) for c in b.columns)
    return Packed(buf, parts, b.names, meta, k)


_NP = {torch.bool: np.bool_, torch.int8: np.int8, torch.int16: np.int16,
       torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
       torch.float64: np.float64, torch.uint8: np.uint8}


def rebuild_clients(p: Packed, n_clients: int) -> list:
    """The tick's one device-to-host transfer, then each client's host
    batch: its first ``n`` gathered rows (``n`` its live count).  None for a
    lane whose live count overflowed the scatter budget (it re-runs
    inline)."""
    host = p.buf.cpu().numpy()
    arrs = [host[o:o + nb].view(_NP[dt]).reshape(shape) for o, nb, dt, shape in p.parts]
    ns = arrs[0]
    outs = []
    for i in range(n_clients):
        n = int(ns[i])
        if n > p.cap:
            outs.append(None)
            continue
        cols, j = [], 1
        for ltype, dictionary, has_valid in p.colmeta:
            data = torch.from_numpy(arrs[j][i, :n].copy())
            j += 1
            valid = None
            if has_valid:
                valid = torch.from_numpy(arrs[j][i, :n].copy())
                j += 1
            cols.append(Column(data, valid, ltype, dictionary))
        outs.append(ColumnBatch(p.names, cols, None, None, device="cpu"))
    return outs
