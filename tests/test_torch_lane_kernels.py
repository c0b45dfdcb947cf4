"""The lane-batched kernel entries (ops/group_kernels.py ``*_lanes``,
ops/segments.py ``segment_reduce_lanes`` / ``seg_*_lanes``) against the JAX
package's kernels under ``jax.vmap`` over the lanes' masks.

The JAX batched dispatcher runs ``jax.vmap`` of the whole plan, so a
Pallas kernel there is a ``pallas_call`` with a lane grid axis; these tests
run the Pallas kernels that way in interpret mode (as tests/test_pallas.py
runs them on the CPU), and the accelerator branch of the segment reductions
under ``vmap`` with the one-hot route forced (as
tests/test_torch_segments.py does).  Inputs are numpy with fixed seeds:
codes and values shared by the lanes, one mask row a lane, including an
all-dead lane, a lane of one live row and odd row counts.

Tolerances: counts and MIN/MAX exactly; float32 sums rtol = atol = 1e-4 (the
Pallas kernels' own test tolerance); the segment kernel's float64 sums
rtol 1e-12 (another summation order).  On the CPU each lane entry runs its
plain version, the per-lane loop over the one-lane plain function, and is
also held to that loop; tests/test_torch_cuda.py holds the CUDA launches to
the same loops on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from baikaldb_tpu.ops import pallas_kernels as pk
from baikaldb_tpu.ops import segments as jseg
from baikaldb_tpu_torch.ops import group_kernels as gk
from baikaldb_tpu_torch.ops import segments as tseg

RTOL = ATOL = 1e-4

CASES = [  # (n, num_groups, lanes, seed)
    (3001, 37, 4, 0),
    (5000, 1000, 3, 1),
    (777, 2049, 8, 2),
    (64, 5, 1, 3),
]


def _inputs(n, ng, G, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-2, ng + 2, n).astype(np.int32)
    values = rng.normal(size=n).astype(np.float32)
    mask = rng.random((G, n)) < rng.uniform(0.2, 0.9, (G, 1))
    if G > 2:
        mask[1] = False                 # an all-dead lane
        mask[2] = False
        mask[2, n // 2] = True          # a lane of one live row
    return codes, values, mask


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _vmapped(fn, codes, values, mask, ng):
    c, v = jnp.asarray(codes), jnp.asarray(values)
    return jax.vmap(lambda m: fn(c, v, m, ng))(jnp.asarray(mask))


@pytest.mark.parametrize("n,ng,G,seed", CASES)
def test_filtered_group_sum_lanes_match_vmapped_pallas(n, ng, G, seed):
    codes, values, mask = _inputs(n, ng, G, seed)
    c_t, s_t = gk.filtered_group_sum_lanes(*_t(codes, values, mask), ng)
    assert c_t.shape == s_t.shape == (G, ng) and c_t.dtype == torch.int64
    c_p, s_p = _vmapped(lambda c, v, m, k: pk.filtered_group_sum(c, v, m, k, interpret=True),
                        codes, values, mask, ng)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_p))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_p), rtol=RTOL, atol=ATOL)
    for g in range(G):
        c1, s1 = gk.filtered_group_sum_plain(*_t(codes, values, mask[g]), ng)
        assert torch.equal(c_t[g], c1) and torch.equal(s_t[g], s1)


@pytest.mark.parametrize("n,ng,G,seed", CASES)
def test_fused_group_aggregate_lanes_match_vmapped_xla(n, ng, G, seed):
    codes, values, mask = _inputs(n, ng, G, seed)
    values[n // 3] = np.nan            # a NaN group: NaN SUM/MIN/MAX in every lane holding it
    out_t = gk.fused_group_aggregate_lanes(*_t(codes, values, mask), ng)
    for g in range(G):
        one = gk.fused_group_aggregate_plain(*_t(codes, values, mask[g]), ng)
        for a, b in zip(out_t, one):
            assert torch.equal(a[g], b) or torch.allclose(a[g], b, equal_nan=True, rtol=0, atol=0)
    clean = values.copy()
    clean[n // 3] = 0.5
    out_t = gk.fused_group_aggregate_lanes(*_t(codes, clean, mask), ng)
    out_x = _vmapped(pk._xla_agg_fallback, codes, clean, mask, ng)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_x[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_x[1]), rtol=RTOL, atol=ATOL)
    for k in (2, 3):
        live = out_t[0].numpy() > 0
        np.testing.assert_array_equal(out_t[k].numpy()[live], np.asarray(out_x[k])[live])


@pytest.mark.parametrize("kind", ["sparse", "skewed"])
def test_fused_group_aggregate_lanes_sparse_and_skewed_match_vmapped_xla(kind):
    """K2's lanes at ~3% live (the dispatcher's D-b share: each lane keeps a
    range of slots under a threshold) and with every code in one slot, each
    lane against the JAX K2 under ``vmap`` and the one-lane plain function:
    counts and MIN/MAX exact, sums rtol = atol = 1e-4."""
    rng = np.random.default_rng(7 if kind == "sparse" else 8)
    n, ng, G = 20_011, 2049, 9
    values = rng.normal(size=n).astype(np.float32)
    if kind == "sparse":
        codes = rng.integers(0, ng, n).astype(np.int32)
        lo = rng.integers(0, ng - 120, (G, 1))
        mask = (codes >= lo) & (codes < lo + 120) & (values * 2 + 1 > rng.normal(size=(G, 1)))
        assert 0.01 < mask.mean() < 0.05
    else:
        codes = np.full(n, 5, dtype=np.int32)
        mask = rng.random((G, n)) < 0.6
    mask[G // 2] = False                # an all-dead lane
    out_t = gk.fused_group_aggregate_lanes(*_t(codes, values, mask), ng)
    out_x = _vmapped(pk._xla_agg_fallback, codes, values, mask, ng)
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_x[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_x[1]), rtol=RTOL, atol=ATOL)
    live = out_t[0].numpy() > 0
    for k in (2, 3):
        np.testing.assert_array_equal(out_t[k].numpy()[live], np.asarray(out_x[k])[live])
    for g in range(G):
        one = gk.fused_group_aggregate_plain(*_t(codes, values, mask[g]), ng)
        for a, b in zip(out_t, one):
            assert torch.equal(a[g], b)


@pytest.mark.parametrize("n,ng,G,seed", CASES)
def test_partition_histogram_lanes_match_vmapped_pallas(n, ng, G, seed):
    codes, _, mask = _inputs(n, ng, G, seed)
    got = gk.partition_histogram_lanes(*_t(codes, mask), ng)
    m = jnp.asarray(mask)
    want = jax.vmap(lambda r: pk.partition_histogram(jnp.asarray(codes), r, ng,
                                                     interpret=True))(m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g in range(G):
        assert torch.equal(got[g], gk.partition_histogram_plain(*_t(codes, mask[g]), ng))


SEG_CASES = [  # (n, segments, lanes, x dtype, seed)
    (2001, 17, 4, np.float64, 0),
    (999, 17, 3, np.float32, 1),
    (5000, 512, 2, np.int64, 2),
    (333, 1, 5, np.int32, 3),
]


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("n,S,G,dt,seed", SEG_CASES)
def test_segment_reduce_lanes_match_vmapped_onehot(monkeypatch, op, n, S, G, dt, seed):
    monkeypatch.setattr(jseg, "_onehot_backend", lambda: True)
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, S + 1, n).astype(np.int32)
    x = (rng.normal(size=n) * 100).astype(dt)
    mask = rng.random((G, n)) < 0.6
    mask[0] = False                     # an all-dead lane
    got = tseg.segment_reduce_lanes(*_t(x, gid, mask), S, op)
    assert got.shape == (G, S)
    jf = {"sum": jseg.seg_sum, "min": jseg.seg_min, "max": jseg.seg_max}[op]
    jx, jg = jnp.asarray(x), jnp.asarray(gid)
    want = np.asarray(jax.vmap(lambda m: jf(jx, jnp.where(m, jg, S), S))(jnp.asarray(mask)))
    if np.issubdtype(dt, np.floating) and op == "sum":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    for g in range(G):
        one = tseg.segment_reduce_plain(*_t(x, np.where(mask[g], gid, S).astype(np.int32)), S, op)
        assert torch.equal(got[g], one)


@pytest.mark.parametrize("fn,op", [(tseg.seg_sum_lanes, "sum"), (tseg.seg_min_lanes, "min"),
                                   (tseg.seg_max_lanes, "max")])
def test_seg_lanes_equal_the_one_lane_route_per_lane(fn, op):
    """The dense group-by's lane entries: each lane equals the one-lane
    ``seg_*`` over ``where(mask[g], gid, S)`` (the serial query's call)."""
    rng = np.random.default_rng(5)
    n, S, G = 4000, 700, 3
    gid = torch.from_numpy(rng.integers(0, S, n).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=n))
    mask = torch.from_numpy(rng.random((G, n)) < 0.5)
    one = {"sum": tseg.seg_sum, "min": tseg.seg_min, "max": tseg.seg_max}[op]
    got = fn(x, gid, mask, S)
    for g in range(G):
        assert torch.equal(got[g], one(x, torch.where(mask[g], gid, S), S))


def test_lane_entries_reject_what_the_kernels_do_not_take():
    codes = torch.zeros(10, dtype=torch.int32)
    values = torch.zeros(10, dtype=torch.float32)
    with pytest.raises(TypeError):
        gk.filtered_group_sum_lanes(codes, values, torch.zeros(10, dtype=torch.bool), 4)
    with pytest.raises(TypeError):
        gk.partition_histogram_lanes(codes, torch.zeros((2, 9), dtype=torch.bool), 4)
    with pytest.raises(ValueError):
        gk.fused_group_aggregate_lanes(codes, values,
                                       torch.zeros((10, 2), dtype=torch.bool).t(), 4)
    with pytest.raises(TypeError):
        tseg.segment_reduce_lanes(values, codes, torch.zeros((0, 10), dtype=torch.bool), 4,
                                  "sum")


# -- the lane kernels' host plans (ops/segments.py lane_plan, ops/group_kernels.py
# lane_plan): how many lanes a block carries, as many one-lane
# tables as fit a block's shared memory, and how
# the lanes spread over the tiles.  The CUDA
# side checks the tile against the tables it builds (tests/test_torch_cuda.py
# holds the two plans' table bytes to the kernels' on the card).

SEG_ACC_BYTES = {  # (op is sum, dtype) -> bytes of the kernel's accumulator
    torch.bool: (4, 4), torch.int32: (4, 4), torch.int64: (8, 8),
    torch.float32: (8, 4), torch.float64: (8, 8),
}


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", list(SEG_ACC_BYTES))
@pytest.mark.parametrize("S", [1, 16, 17, 64, 512, 2048, 4096, 16384])
def test_segment_lane_plan_fits_every_dtype_and_segment_count(op, dtype, S):
    acc = SEG_ACC_BYTES[dtype][0 if op == "sum" else 1]
    slot = acc * S
    layout, nbytes = tseg.table_layout(op, dtype, S)
    # the one-lane layout: a private copy a thread while 256 of them fit 48
    # KB, else copies a warp within 64 KB, else one table a block
    want = "private" if slot * 256 <= 48 * 1024 else "warp" if slot * 2 <= 64 * 1024 \
        else "block"
    assert layout == want
    replicas = {"private": 256, "warp": max(1, min(8, 64 * 1024 // slot)), "block": 1}[layout]
    assert nbytes == slot * replicas
    for G in (1, 2, 5, 7, 8, 9, 63, 64, 65, 1000):
        plan = tseg.lane_plan(op, dtype, S, G)
        assert plan.layout == layout and plan.table_bytes == nbytes
        assert 1 <= plan.tile <= tseg.LANE_TILE_MAX
        assert plan.tile * nbytes <= tseg.LANE_SMEM_MAX
        fit = min(tseg.LANE_TILE_MAX, tseg.LANE_SMEM_MAX // nbytes)
        assert plan.fit == fit and plan.tiles == -(-G // fit)     # the fewest tiles
        assert plan.tile * (plan.tiles - 1) < G <= plan.tile * plan.tiles


@pytest.mark.parametrize("mode,S,dtype,fit", [
    ("private", 17, torch.float64, 6),      # query (a)'s float64 sums: 34,816 bytes a lane
    ("private", 17, torch.int64, 6),        # its COUNT(*)
    ("private", 17, torch.int32, 13),       # int32 counts: 17,408 bytes
    ("warp", 2048, torch.float64, 3),       # 4 copies of 16 KB
    ("block", 2048, torch.float64, 14),     # one copy of 16 KB
    ("block", 16384, torch.float64, 1),     # 128 KB: one lane a block
    ("block", 16384, torch.int32, 3),       # 64 KB
])
def test_segment_lane_plan_in_each_table_mode(mode, S, dtype, fit):
    """``fit``: the lanes whose tables fit 227 KB; a block carries at most
    ``LANE_TILE_MAX`` of them."""
    tile = min(fit, tseg.LANE_TILE_MAX)
    plan = tseg.lane_plan("sum", dtype, S, 64, mode)
    assert (plan.layout, plan.fit, plan.tile, plan.tiles) == \
        (mode, tile, -(-64 // -(-64 // tile)), -(-64 // tile))
    assert plan.tile * plan.table_bytes <= tseg.LANE_SMEM_MAX < (fit + 1) * plan.table_bytes


def test_segment_lane_plan_refuses_a_private_table_past_the_limit():
    with pytest.raises(ValueError):
        tseg.table_layout("sum", torch.float64, 16384, "private")


@pytest.mark.parametrize("fit", [1, 2, 3, 6, 8, 9, 16])
def test_lane_tiles_spread_the_lanes_over_the_fewest_tiles(fit):
    for G in list(range(1, 70)) + [255, 256, 257, 65535]:
        tile, tiles = gk.lane_tiles(G, fit)
        assert 1 <= tile <= fit and tiles == -(-G // fit)
        sizes = [min(tile, G - k * tile) for k in range(tiles)]
        assert sum(sizes) == G and min(sizes) >= 1
        assert max(sizes) - min(sizes) <= tiles     # even but for the last tile
        assert gk.lane_tiles(G, fit, tile=1) == (1, G)
    with pytest.raises(ValueError):
        gk.lane_tiles(8, fit, tile=fit + 1)


@pytest.mark.parametrize("ng", [1, 2, 17, 37, 1000, 2049, 4096])
def test_group_agg_lane_plan_fits_k1_and_k3_tables(ng):
    for G, (kind, per_slot) in ((G, k) for G in (1, 8, 9, 15, 16, 17, 63, 64, 65)
                                for k in ((gk.KIND_SUM, 12), (gk.KIND_HIST, 4))):
        plan = gk.lane_plan(kind, ng, G)
        assert plan.table_bytes == -(-per_slot * ng // 8) * 8      # whole words
        assert plan.tile * plan.table_bytes <= gk.LANE_SMEM_MAX
        assert 1 <= plan.tile <= gk.LANE_TILE_MAX
        assert plan.fit == min(gk.LANE_TILE_MAX, gk.LANE_SMEM_MAX // plan.table_bytes)
        assert plan.tiles == -(-G // plan.fit)
        assert plan.tile * (plan.tiles - 1) < G <= plan.tile * plan.tiles
    # the dense GROUP BY's 2049 slots: K1 carries 8 of 64 lanes a block, K3 16
    if ng == 2049:
        assert gk.lane_plan(gk.KIND_SUM, ng, 64)[2:] == (8, 8)
        assert gk.lane_plan(gk.KIND_HIST, ng, 64)[2:] == (16, 4)


@pytest.mark.parametrize("ng", [1, 17, 37, 2049, 4096])
def test_group_agg_lane_plan_fits_k2_tables(ng):
    """K2's tile: 20 bytes a slot in whole words, as many lanes as fit 227 KB,
    at most ``AGG_LANE_MAX``, spread as ``lane_tiles`` does; 2049 slots fit
    4 lanes, 4096 fit 2."""
    for G in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 63, 64, 65):
        plan = gk.lane_plan(gk.KIND_AGG, ng, G)
        assert plan.table_bytes == -(-20 * ng // 8) * 8
        assert plan.fit == min(gk.AGG_LANE_MAX, gk.LANE_SMEM_MAX // plan.table_bytes)
        assert 1 <= plan.tile <= plan.fit <= gk.AGG_LANE_MAX <= gk.LANE_TILE_MAX
        assert plan.tile * plan.table_bytes <= gk.LANE_SMEM_MAX
        assert plan.tiles == -(-G // plan.fit)
        assert (plan.tile, plan.tiles) == gk.lane_tiles(G, plan.fit)
        assert plan.tile * (plan.tiles - 1) < G <= plan.tile * plan.tiles
    assert gk.lane_plan(gk.KIND_AGG, ng, 64).fit == {1: 4, 17: 4, 37: 4, 2049: 4, 4096: 2}[ng]


def test_k2_lane_plan_fits_every_slot_count_and_tile():
    """K2's tile for every slot count: as many lanes as fit 227 KB, at most
    ``AGG_LANE_MAX``, and no forced tile beyond the fit."""
    for ng in range(1, gk.MAX_GROUPS + 1):
        plan = gk.lane_plan(gk.KIND_AGG, ng, 1)
        assert plan.table_bytes == -(-20 * ng // 8) * 8
        assert 1 <= plan.fit <= gk.AGG_LANE_MAX
        assert plan.fit * plan.table_bytes <= gk.LANE_SMEM_MAX
        if plan.fit < gk.AGG_LANE_MAX:
            assert (plan.fit + 1) * plan.table_bytes > gk.LANE_SMEM_MAX
        with pytest.raises(ValueError):
            gk.lane_plan(gk.KIND_AGG, ng, 64, plan.fit + 1)


@pytest.mark.parametrize("kind", ["D-b", "0.6"])
def test_lane_tiles_masks_draw_the_dispatcher_shapes(kind):
    """bench/lane_tiles.py's masks (also chip_smoke.py's D-b timing): D-b keeps
    a range of 20 to 100 slots a lane under a value threshold, about 2% live;
    a share keeps that share of rows at random."""
    from baikaldb_tpu_torch.bench import lane_tiles

    gen = torch.Generator().manual_seed(3)
    n, G = 60_000, 6
    codes = torch.randint(0, 2049, (n,), generator=gen, dtype=torch.int32)
    values = torch.randn(n, generator=gen)
    m = lane_tiles.masks(kind, n, G, codes, values, gen)
    assert m.shape == (G, n) and m.dtype == torch.bool
    if kind == "0.6":
        assert abs(float(m.float().mean()) - 0.6) < 0.01
        return
    assert 0.005 < float(m.float().mean()) < 0.05
    for g in range(G):
        kept = codes[m[g]]
        assert 0 < int(kept.max()) - int(kept.min()) < 100
