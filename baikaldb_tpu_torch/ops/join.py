"""Equi-joins in torch (the port of ``baikaldb_tpu/ops/join.py``).

The design is the JAX package's sort join: sort the build side by key once,
then probe with a vectorized binary search (``torch.searchsorted``).
Duplicate build keys are handled by [lo, hi) match ranges and an
offset-inversion expansion.  A unique build key over a dense integer domain
takes ``dense_join`` instead: one scatter builds a position table, one
gather probes it.

- Join keys: one column of any fixed-width type, or two 32-bit-packable
  columns packed into one int64.  String keys join on dictionary codes:
  both sides' dictionaries are merged on the host first.
- NULL keys never match (SQL semantics); dead rows (sel=False) never match.
  A LEFT JOIN keeps its NULL-key probe rows, with a NULL build side.
- Output size: torch has no static shapes, so ``join`` and ``cross_join``
  emit exactly the matched rows.  The match total is read to the host once
  per expanding join (it sizes the output); there is no capacity and no
  overflow-retry loop, and the second value returned, kept for the JAX
  package's call shape, is that total.  ``dense_join``, ``semi_join_neq``
  and semi/anti ``join`` keep the probe's rows and refine its ``sel``.
- Indices are clamped explicitly wherever the JAX code relies on
  ``mode="clip"``: an out-of-range index on CUDA is a device-side assert.
- ``order=``: a host permutation that sorts the build side's keys over the
  whole base table (storage/column_store.py ``sort_permutation``, fed by
  the session's presort), so only a stable partition by deadness stays on
  the device.
- ``radix_join`` hash-partitions the build side into buckets and sorts
  each one (ops/radix.py); the executor takes it under the flag
  ``radix_join_buckets``.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..analysis.runtime import host_read
from ..column.batch import Column, ColumnBatch, dtype_max
from ..column.dictionary import NULL_CODE, merge as dict_merge
from ..types import LType
from .compact import stable_partition


def _remap_codes(codes: torch.Tensor, table) -> torch.Tensor:
    """Old dictionary codes -> merged codes (NULL stays NULL)."""
    if len(table) == 0:
        return torch.full_like(codes, int(NULL_CODE))
    t = torch.as_tensor(table, device=codes.device)
    mapped = t[codes.clamp(0, len(table) - 1).to(torch.int64)]
    return torch.where(codes >= 0, mapped, torch.full_like(mapped, int(NULL_CODE)))


def _align_string_keys(probe: ColumnBatch, probe_keys: list[str],
                       build: ColumnBatch, build_keys: list[str]):
    """Remap string key columns of both sides onto merged dictionaries so code
    equality == string equality.  Host work is O(|dict|)."""

    def retag(batch, name, col):
        cols = list(batch.columns)
        cols[batch.names.index(name)] = col
        return ColumnBatch(batch.names, cols, batch.sel, batch.num_rows,
                           device=batch.device)

    for pk, bk in zip(probe_keys, build_keys):
        pc, bc = probe.column(pk), build.column(bk)
        if pc.ltype is not LType.STRING and bc.ltype is not LType.STRING:
            continue
        if pc.dictionary is None or bc.dictionary is None:
            raise ValueError(f"string join key {pk}/{bk} lacks a dictionary")
        if pc.dictionary is bc.dictionary or pc.dictionary._id == bc.dictionary._id:
            continue
        m, ra, rb = dict_merge(pc.dictionary, bc.dictionary)
        probe = retag(probe, pk, replace(pc, data=_remap_codes(pc.data, ra), dictionary=m))
        build = retag(build, bk, replace(bc, data=_remap_codes(bc.data, rb), dictionary=m))
    return probe, build


_PACK32_TYPES = (LType.BOOL, LType.INT8, LType.INT16, LType.INT32,
                 LType.UINT32, LType.DATE, LType.STRING)


def _key_array(batch: ColumnBatch, names: list[str],
               wide_keys_ok: bool = False):
    """Pack 1-2 key columns into a single sortable tensor + validity.

    ``wide_keys_ok``: the planner verified (from statistics) that wider
    integer values fit 32-bit packing; without it, only types whose every
    value packs losslessly are accepted — an unbounded int64 must fail
    loudly, not alias silently."""
    cols = [batch.column(n) for n in names]
    valid = None
    for c in cols:
        if c.validity is not None:
            valid = c.validity if valid is None else (valid & c.validity)
    if len(cols) == 1:
        d = cols[0].data
        if d.dtype is torch.bool:
            d = d.to(torch.int32)
        return d, valid
    if len(cols) == 2:
        for c in cols:
            ok = c.ltype in _PACK32_TYPES or \
                (wide_keys_ok and c.ltype.is_integer)
            if not ok:
                raise ValueError(
                    "2-key sort-join requires 32-bit-packable keys "
                    "(or planner-verified bounds); demote to residual "
                    "equality otherwise")
        a = cols[0].data.to(torch.int64)
        b = cols[1].data.to(torch.int64)
        return (a << 32) | (b & 0xFFFFFFFF), valid
    raise ValueError(">2 join key columns: planner must demote extras to "
                     "residual equality")


def _build_dead(build: ColumnBatch, bvalid) -> torch.Tensor:
    """Dead mask for the build side: sel-dead or NULL-key rows."""
    dead = torch.zeros(len(build), dtype=torch.bool, device=build.device)
    if build.sel is not None:
        dead = dead | ~build.sel
    if bvalid is not None:
        dead = dead | ~bvalid
    return dead


def _probe_dead(probe: ColumnBatch, pvalid):
    """(sel_dead, dead): sel-dead alone, and sel-dead-or-NULL-key."""
    sel_dead = ~probe.sel if probe.sel is not None \
        else torch.zeros(len(probe), dtype=torch.bool, device=probe.device)
    dead = sel_dead
    if pvalid is not None:
        dead = dead | ~pvalid
    return sel_dead, dead


def _live_sorted(keys: torch.Tensor, dead: torch.Tensor, presorted: bool = False,
                 order=None):
    """The ``lexsort((keys, dead))`` layout: live rows sorted by key (stable)
    in front, dead rows behind them, the dead tail's keys replaced by the
    dtype's maximum.  ``presorted``: the live rows already arrive in key
    order, so a stable partition by deadness replaces the sort; ``order``:
    a permutation that sorts ``keys`` (the host presort), composed with that
    partition.  -> (order, sorted keys, live count as a 0-d tensor)."""
    if order is not None:
        order = order.to(torch.int64)
        order = order[stable_partition(~dead[order])]
    elif presorted:
        order = stable_partition(~dead)
    else:
        by_key = torch.sort(keys, stable=True).indices
        order = by_key[stable_partition(~dead[by_key])]
    n_live = (~dead).sum()
    pos = torch.arange(len(keys), device=keys.device)
    srt = torch.where(pos < n_live, keys[order],
                      torch.full_like(keys, dtype_max(keys.dtype)))
    return order, srt, n_live


def _search(sorted_keys: torch.Tensor, values: torch.Tensor, side: str):
    """``searchsorted`` with the JAX package's dtype promotion (torch needs
    both sides in one dtype)."""
    dt = torch.promote_types(sorted_keys.dtype, values.dtype)
    return torch.searchsorted(sorted_keys.to(dt).contiguous(), values.to(dt).contiguous(),
                              side=side)


def semi_join_neq(probe: ColumnBatch, probe_keys: list[str],
                  build: ColumnBatch, build_keys: list[str],
                  neq_probe: str, neq_build: str, how: str = "semi",
                  order=None):
    """[NOT] EXISTS with equality keys plus ONE ``build_col <> probe_col``
    residual — the TPC-H q21 shape — without expanding the many-to-many
    match space.  For each probe row the residual-satisfying match count is

        #(key matches with build_col NOT NULL)  -  #(key, build_col=probe_col)

    both computed as range counts over one build array sorted by the packed
    (key, residual column).  ``order``: the host presort of that packed
    array over the whole base table; dead rows then stay among the live
    ones, and a prefix sum of deadness turns value-range counts into live
    counts.  Returns (out_batch, 0).  Key and residual columns must be
    32-bit-safe (the planner checks)."""
    probe, build = _align_string_keys(probe, probe_keys, build, build_keys)
    pk, pvalid = _key_array(probe, probe_keys)
    bk, bvalid = _key_array(build, build_keys)
    a = probe.column(neq_probe)
    b = build.column(neq_build)

    bdead = _build_dead(build, bvalid)
    # rows whose residual column is NULL can never satisfy b <> a (NULL
    # comparisons are not TRUE): dead for both counts
    if b.validity is not None:
        bdead = bdead | ~b.validity

    mask32 = 0xFFFFFFFF
    pk2 = (bk.to(torch.int64) << 32) | (b.data.to(torch.int64) & mask32)
    base = pk.to(torch.int64) << 32
    pp = base | (a.data.to(torch.int64) & mask32)
    if order is not None:
        order = order.to(torch.int64)
        pk2_sorted = pk2[order]
        dead_sorted = bdead[order].to(torch.int64)
        cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=pk2.device),
                         torch.cumsum(dead_sorted, 0)])

        def live_range(lo_v, hi_v):
            lo = _search(pk2_sorted, lo_v, "left")
            hi = _search(pk2_sorted, hi_v, "right")
            return (hi - lo) - (cum[hi] - cum[lo])

        key_cnt = live_range(base, base | mask32)
        eq_cnt = live_range(pp, pp)
    else:
        _, pk2_sorted, n_live = _live_sorted(pk2, bdead)

        def clamp(x):
            return torch.minimum(x, n_live)

        key_lo = clamp(_search(pk2_sorted, base, "left"))
        # upper bound via side="right" on the all-ones low word: adding
        # 2^32 would overflow int64 for a key at dtype max
        key_hi = clamp(_search(pk2_sorted, base | mask32, "right"))
        pp_lo = clamp(_search(pk2_sorted, pp, "left"))
        pp_hi = clamp(_search(pk2_sorted, pp, "right"))
        key_cnt = key_hi - key_lo
        eq_cnt = pp_hi - pp_lo

    _, pdead = _probe_dead(probe, pvalid)
    if a.validity is not None:
        pdead = pdead | ~a.validity      # a NULL: residual never TRUE
    counts = torch.where(pdead, 0, key_cnt - eq_cnt)
    if how == "semi":
        return probe.and_sel(counts > 0), 0
    if how == "anti":
        return probe.and_sel(counts == 0), 0
    raise ValueError(f"semi_join_neq: unsupported how {how!r}")


def join(probe: ColumnBatch, probe_keys: list[str],
         build: ColumnBatch, build_keys: list[str],
         how: str = "inner", suffix: str = "_r", wide_keys_ok: bool = False,
         build_sorted: bool = False, order=None):
    """Returns (out_batch, output rows).

    how: inner | left | semi | anti.
    - semi/anti keep the probe's rows and just refine sel (output rows 0).
    - inner/left emit one row per (probe row, matching build row), and a
      LEFT JOIN one row with a NULL build side for each live probe row
      without a match.
    ``build_sorted``: the planner proved the build side arrives key-sorted
    over its live rows, so a stable partition by deadness replaces the sort.
    ``order``: a permutation sorting the build keys (the host presort of the
    base table), composed with that partition instead of a device sort.
    Column names: probe names keep their own; clashing build names get suffix.
    """
    probe, build = _align_string_keys(probe, probe_keys, build, build_keys)
    pk, pvalid = _key_array(probe, probe_keys, wide_keys_ok)
    bk, bvalid = _key_array(build, build_keys, wide_keys_ok)

    # build side ordered by (is_dead, key): live rows form a contiguous
    # sorted prefix of exactly n_live entries, the dead tail holds the
    # dtype's maximum; a live key equal to that maximum still sorts before
    # every dead row, so the first-dead clamp below is exact
    bdead = _build_dead(build, bvalid)
    order, bk_sorted, n_live = _live_sorted(bk, bdead, build_sorted, order)

    lo = _search(bk_sorted, pk, "left")
    hi = _search(bk_sorted, pk, "right")
    psel_dead, pdead = _probe_dead(probe, pvalid)
    counts = torch.where(pdead, 0, hi - lo)
    # drop matches that land in the dead tail (probe key == sentinel value)
    counts = torch.where(lo >= n_live, 0, torch.minimum(counts, n_live - lo))

    if how == "semi":
        return probe.and_sel(counts > 0), 0
    if how == "anti":
        return probe.and_sel(counts == 0), 0

    def bidx_of(pi, k):
        bpos = lo[pi] + k                      # index into the sorted build
        return order[bpos.clamp(0, len(build) - 1)]

    return _expand_matches(probe, build, how, counts, psel_dead, bidx_of, suffix)


def radix_join(probe: ColumnBatch, probe_keys: list[str],
               build: ColumnBatch, build_keys: list[str],
               how: str = "inner", suffix: str = "_r", wide_keys_ok: bool = False,
               n_buckets: int = 256):
    """The hash-partitioned variant of ``join`` (ops/radix.py): the build
    side partitions into ``n_buckets`` by key hash and sorts per bucket;
    probes binary-search only their bucket's row.  The same rows as
    ``join`` (inner / left / semi / anti, NULL keys, name suffixing); the
    order of one probe row's matches may differ among equal build keys.
    Returns (out_batch, output rows, width), ``width`` the largest live
    bucket, where the JAX package reports the width it needs."""
    from .radix import radix_build, radix_probe

    probe, build = _align_string_keys(probe, probe_keys, build, build_keys)
    pk, pvalid = _key_array(probe, probe_keys, wide_keys_ok)
    bk, bvalid = _key_array(build, build_keys, wide_keys_ok)
    bdead = _build_dead(build, bvalid)
    sort_src, sort_keys, width = radix_build(bk, bdead, n_buckets)
    psel_dead, pdead = _probe_dead(probe, pvalid)
    b, lo, hi = radix_probe(pk, pdead, sort_keys, n_buckets)
    # live rows fill the front of their bucket's row, so clamping to the
    # bucket's live count keeps a probe key equal to the padding out of it
    live_w = (sort_src < len(build)).sum(1)
    bl = live_w[b.to(torch.int64)]
    lo = torch.minimum(lo, bl)
    hi = torch.minimum(hi, bl)
    counts = torch.where(pdead, 0, hi - lo)

    if how == "semi":
        return probe.and_sel(counts > 0), 0, width
    if how == "anti":
        return probe.and_sel(counts == 0), 0, width

    flat_src = sort_src.reshape(-1)

    def bidx_of(pi, k):
        bpos = b[pi].to(torch.int64) * width + lo[pi] + k
        return flat_src[bpos.clamp(0, flat_src.shape[0] - 1)].clamp(0, len(build) - 1)

    out, total = _expand_matches(probe, build, how, counts, psel_dead, bidx_of, suffix)
    return out, total, width


def _expand_matches(probe: ColumnBatch, build: ColumnBatch, how: str,
                    counts, psel_dead, bidx_of, suffix: str):
    """Per-probe match counts -> one output row per match (and, for a LEFT
    JOIN, one per unmatched live probe row).  ``bidx_of(pi, k)`` maps (probe
    row, match ordinal) -> build row index."""
    if how == "left":
        # NULL-key probe rows still survive a LEFT JOIN (with NULL build side);
        # only sel-dead rows are dropped
        out_counts = torch.maximum(counts, (~psel_dead).to(counts.dtype))
    elif how == "inner":
        out_counts = counts
    else:
        raise ValueError(f"unknown join type {how}")

    dev = probe.device
    out_counts = out_counts.to(torch.int64)
    total = int(host_read(out_counts.sum())) if len(probe) else 0   # the one host read
    starts = torch.cumsum(out_counts, 0) - out_counts
    pi = torch.repeat_interleave(torch.arange(len(probe), device=dev), out_counts,
                                 output_size=total)
    k = torch.arange(total, device=dev) - starts[pi]      # match ordinal
    matched = k < counts[pi]
    if len(build):
        bidx = bidx_of(pi, k)
    else:
        bidx = torch.zeros(total, dtype=torch.int64, device=dev)

    out_p = probe.gather(pi)
    out_b = build.gather(bidx)
    names = list(out_p.names)
    cols = list(out_p.columns)
    for n, c in zip(out_b.names, out_b.columns):
        if how == "left":
            v = c.validity & matched if c.validity is not None else matched
            c = replace(c, validity=v)
        names.append(n if n not in names else n + suffix)
        cols.append(c)
    return ColumnBatch(tuple(names), cols, None, None, device=dev), total


def _align_multiway_strings(probe: ColumnBatch, level_keys: list[list[str]],
                            builds: list):
    """Align string key columns of the probe and EVERY build side onto one
    shared code space.  ``level_keys[i]`` holds side i's probe key columns.
    Two passes: the first grows the probe's dictionary to the union of all
    sides; the second re-aligns each build against that union (a second
    merge with a subset is value-stable), so a probe column compared against
    N independently-dictionaried builds never keeps a build's stale codes."""
    for _ in range(2):
        for i, (bb, bk) in enumerate(builds):
            probe, bb = _align_string_keys(probe, level_keys[i], bb, bk)
            builds[i] = (bb, bk)
    return probe, builds


def multiway_join(probe: ColumnBatch, probe_keys: list[str],
                  builds: list, hows: list[str], suffix: str = "_r",
                  wide_keys_ok: bool = False,
                  level_keys: list[list[str]] | None = None,
                  packs: list[bool] | None = None):
    """Fused multiway equi-join: ONE probe stream joined against N build
    sides in a single pass (the Efficient Multiway Hash Join shape).  Every
    level's key columns live on the probe stream: by default all levels
    share ``probe_keys``; ``level_keys[i]`` gives level i its own probe
    columns (the keyed exchange scheduler's mixed-key segments).

    ``builds``: list of (build_batch, build_key_names); ``hows[i]``: inner |
    left per level.  The same rows, in the same order, as the left-deep
    chain ``((probe JOIN build_1) JOIN build_2) ...``: each build side sorts
    by (deadness, key) once, the probe binary-searches every side, and the
    output enumerates the cross product of the per-side match ranges by one
    mixed-radix decode (last build fastest).  The probe rows are gathered
    once; no intermediate join result exists.  The planner builds this only
    on a mesh.

    Returns (out_batch, output rows), the rows read to the host once to size
    the output, as ``join`` does."""
    builds = list(builds)
    if level_keys is None:
        level_keys = [list(probe_keys)] * len(builds)
    if packs is None:
        packs = [wide_keys_ok] * len(builds)
    probe, builds = _align_multiway_strings(probe, level_keys, builds)
    dev = probe.device
    psel_dead = ~probe.sel if probe.sel is not None \
        else torch.zeros(len(probe), dtype=torch.bool, device=dev)

    per_side = []       # (out counts, match counts, lo, order) per build
    pk_cache: dict = {}  # shared-key levels pack the probe columns once
    for (bb, bkeys), how, pkeys, wide in zip(builds, hows, level_keys, packs):
        ck = (tuple(pkeys), bool(wide))
        if ck not in pk_cache:
            pk_cache[ck] = _key_array(probe, pkeys, wide)
        pk, pvalid = pk_cache[ck]
        pdead = psel_dead if pvalid is None else (psel_dead | ~pvalid)
        bk, bvalid = _key_array(bb, bkeys, wide)
        order, bk_sorted, n_live = _live_sorted(bk, _build_dead(bb, bvalid))
        lo = _search(bk_sorted, pk, "left")
        hi = _search(bk_sorted, pk, "right")
        counts = torch.where(pdead, 0, hi - lo)
        counts = torch.where(lo >= n_live, 0, torch.minimum(counts, n_live - lo))
        if how == "left":
            # NULL-key probe rows still survive (NULL build side); only
            # sel-dead probe rows are dropped, as in the binary join
            oc = torch.maximum(counts, (~psel_dead).to(counts.dtype))
        elif how == "inner":
            oc = counts
        else:
            raise ValueError(f"multiway_join: unsupported how {how!r}")
        per_side.append((oc, counts, lo, order))

    out_counts = torch.ones(len(probe), dtype=torch.int64, device=dev)
    for oc, _, _, _ in per_side:
        out_counts = out_counts * oc.to(torch.int64)
    total = int(host_read(out_counts.sum())) if len(probe) else 0   # the one host read
    starts = torch.cumsum(out_counts, 0) - out_counts
    pi = torch.repeat_interleave(torch.arange(len(probe), device=dev), out_counts,
                                 output_size=total)
    k = torch.arange(total, device=dev) - starts[pi]

    # mixed-radix decode of the per-probe-row match ordinal: last build
    # varies fastest (the chained left-deep expansion order)
    ordinals = [None] * len(per_side)
    rem = k
    for i in reversed(range(len(per_side))):
        d = per_side[i][0][pi].to(torch.int64).clamp(min=1)
        ordinals[i] = rem % d
        rem = rem // d

    out_p = probe.gather(pi)
    names = list(out_p.names)
    cols = list(out_p.columns)
    for (oc, counts, lo, order), how, ki, (bb, _bk) in zip(per_side, hows, ordinals,
                                                         builds):
        matched = ki < counts[pi]
        if len(bb):
            bidx = order[(lo[pi] + ki).clamp(0, len(bb) - 1)]
        else:
            bidx = torch.zeros(total, dtype=torch.int64, device=dev)
        out_b = bb.gather(bidx)
        for n, c in zip(out_b.names, out_b.columns):
            if how == "left":
                v = c.validity & matched if c.validity is not None else matched
                c = replace(c, validity=v)
            names.append(n if n not in names else n + suffix)
            cols.append(c)
    return ColumnBatch(tuple(names), cols, None, None, device=dev), total


def _dense_slots(batch: ColumnBatch, keys: list[str],
                 los: list[int], spans: list[int]):
    """Row -> slot in the row-major product space of the key domains,
    plus an in-domain/valid mask (NULL or out-of-bounds keys excluded)."""
    dev = batch.device
    slot = torch.zeros(len(batch), dtype=torch.int32, device=dev)
    ok = torch.ones(len(batch), dtype=torch.bool, device=dev)
    stride = 1
    for k, lo, sp in reversed(list(zip(keys, los, spans))):
        c = batch.column(k)
        # bounds-check in int64 before narrowing: a value beyond int32 must
        # fall out of domain, not alias a slot after truncation
        wide = c.data.to(torch.int64) - lo
        ok = ok & (wide >= 0) & (wide < sp)
        if c.validity is not None:
            ok = ok & c.validity
        slot = slot + torch.where(ok, wide, 0).to(torch.int32) * stride
        stride *= sp
    return slot, ok


def dense_join(probe: ColumnBatch, probe_keys: list[str],
               build: ColumnBatch, build_keys: list[str],
               los: list[int], spans: list[int], how: str = "inner",
               suffix: str = "_r"):
    """PK-FK join over a dense integer key domain.  When the build side's
    key (or composite key) is unique (primary/unique index) with host
    statistics bounding each column to [lo, lo+span), the hash table
    degenerates to a dense position table over the product space: one
    scatter builds it, one gather probes it.  A unique build key means at
    most one match per probe row, so the output keeps the probe's rows.

    Dead and out-of-domain build rows all scatter into the spillway slot
    ``size``; several writers there make the scatter nondeterministic on
    CUDA, which is harmless because that slot is never read.  The live
    slots are distinct by the planner's uniqueness proof.

    Returns (out_batch, 0)."""
    probe, build = _align_string_keys(probe, probe_keys, build, build_keys)
    dev = probe.device
    size = 1
    for sp in spans:
        size *= sp

    slot_b, ok_b = _dense_slots(build, build_keys, los, spans)
    if build.sel is not None:
        ok_b = ok_b & build.sel
    table = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
    table[torch.where(ok_b, slot_b, size).to(torch.int64)] = \
        torch.arange(len(build), dtype=torch.int32, device=dev)

    psel_dead = ~probe.sel if probe.sel is not None \
        else torch.zeros(len(probe), dtype=torch.bool, device=dev)
    slot_p, ok_p = _dense_slots(probe, probe_keys, los, spans)
    in_dom = ok_p & ~psel_dead
    bidx = table[slot_p.clamp(0, size - 1).to(torch.int64)]
    matched = in_dom & (bidx >= 0)

    if how == "semi":
        return probe.and_sel(matched), 0
    if how == "anti":
        return probe.and_sel(~matched), 0
    if how == "inner":
        sel = probe.sel_mask() & matched
    elif how == "left":
        # NULL-key probe rows survive a LEFT JOIN (with NULL build side);
        # only sel-dead rows are dropped
        sel = probe.sel_mask()
    else:
        raise ValueError(f"unknown dense join type {how}")

    out_b = build.gather(bidx.clamp(min=0))
    names = list(probe.names)
    cols = list(probe.columns)
    for n, c in zip(out_b.names, out_b.columns):
        v = c.validity & matched if c.validity is not None else matched
        cols.append(replace(c, validity=v))
        names.append(n if n not in names else n + suffix)
    return ColumnBatch(tuple(names), cols, sel, None, device=dev), 0


def cross_join(probe: ColumnBatch, build: ColumnBatch, suffix: str = "_r"):
    """Cartesian product of the live rows of both sides (reference: a
    JoinNode without equality conditions).  Returns (out_batch, rows)."""
    dev = probe.device
    pl = host_read(probe.sel_mask(), torch.nonzero).reshape(-1)
    bl = host_read(build.sel_mask(), torch.nonzero).reshape(-1)
    nb = bl.shape[0]
    total = pl.shape[0] * nb
    j = torch.arange(total, device=dev)
    out_p = probe.gather(pl[j // max(nb, 1)] if total else j)
    out_b = build.gather(bl[j % max(nb, 1)] if total else j)
    names = list(out_p.names)
    cols = list(out_p.columns)
    for n, c in zip(out_b.names, out_b.columns):
        names.append(n if n not in names else n + suffix)
        cols.append(c)
    return ColumnBatch(tuple(names), cols, None, None, device=dev), total


def membership(key: Column, sub: ColumnBatch, negate: bool) -> Column:
    """SQL three-valued ``key [NOT] IN (subquery)`` over the subquery's
    first column: a NULL key gives NULL, and a miss gives NULL when the list
    holds a NULL.  An empty list (no live rows) compares nothing, so the
    result is non-NULL even for NULL keys."""
    dev = key.data.device
    n = len(key)
    if len(sub) == 0:
        data = torch.full((n,), bool(negate), dtype=torch.bool, device=dev)
        return Column(data, None, LType.BOOL)
    sub_name = sub.names[0]
    probe = ColumnBatch(("k",), [key], None, None, device=dev)
    probe2, build2 = _align_string_keys(probe, ["k"], sub, [sub_name])
    xc = probe2.column("k")
    bc = build2.column(sub_name)
    bsel = sub.sel_mask()
    bvalid = bc.valid_mask() & bsel
    _, bsorted, nlive = _live_sorted(bc.data, ~bvalid)
    pos = _search(bsorted, xc.data, "left")
    dt = torch.promote_types(bsorted.dtype, xc.data.dtype)
    hit = (pos < nlive) & \
        (bsorted[pos.clamp(0, len(sub) - 1)].to(dt) == xc.data.to(dt))
    has_null_in_list = (bsel & ~bc.valid_mask()).any()
    data = ~hit if negate else hit
    live_empty = nlive == 0
    validity = (xc.valid_mask() | live_empty) & (hit | ~has_null_in_list)
    return Column(data, validity, LType.BOOL)
