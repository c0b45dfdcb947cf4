"""GPU smoke run of baikaldb_tpu_torch: build the kernels, hold each against
its plain torch version, drive single-table SQL at real size resident and
streamed, run the 22 TPC-H queries and the analytic queries on the card,
the egress functions and catalog statements on the card against the CPU,
the radix join, the host presort and a table on a 3-store Raft fleet
(rebuilt from its replicas after a leader kill), the same table on a
3-store TCP cluster of daemon processes (pushed fragments, the attached
image through the kernels, the cold tier, the distributed binlog),
vector search (VECTOR columns, the ANN index) at 1M x 128, the MPP mesh (8
shards on the card: the 100M rows and TPC-H), the HTAP write path
(snapshot reads over the 100M rows under writes, sysbench, recovery), and
dispatch (the plan cache, PREPARE / EXECUTE, EXPLAIN ANALYZE, 64 concurrent
clients through the batched dispatcher with the lane-batched kernels), and
partitioned tables, global indexes, MATCH and the session surface, and the
lifecycle plane (rollups, a materialized view, change capture, online ADD
INDEX, TTL), and the observability plane and users (SHOW PROCESSLIST, KILL
between streamed chunks and in the dispatcher's queue, SHOW STATUS /
PROFILE, the flight recorder, grants), and the MySQL wire (the 100M-row
queries and prepared statements from a Pool through the server, a frontend
process over the TCP cluster) and the ten chaos scenarios on the card.

    python3 chip_smoke.py [--rows N] [--seed S] [--tpch-scale S]
                          [--compare-with DIR]

Phases (any failure ends the run with a non-zero exit; nothing is caught):

1. the card: ``nvidia-smi`` name and power limit; CUDA is required.
2. kernels: build ``baikaldb_tpu_torch/ops/csrc/group_agg.cu``,
   ``segments.cu`` and ``dense_agg.cu`` with nvcc for sm_90a (one nvcc
   each, started together),
   then hold K1 ``filtered_group_sum``, K2 ``fused_group_aggregate``
   and K3 ``partition_histogram`` against their plain versions on the card:
   at the SQL path's shape (``--rows`` rows, 2049 groups), at the streamed
   path's (65,536 and 1,048,576 rows, and the ragged last chunk of
   ``--rows``), at 2^24 and at a ragged row count with 513/2049/4096
   groups, and on edge cases (all rows
   masked, codes < 0 and >= ng, an empty group, +NaN and -NaN in a group,
   inputs that are views at element offsets 1-3), and one group of 2^24 + 1
   rows; K1-K3 also at 8 slots and 2^20 and 2^24 rows, the destinations of
   a mesh exchange at a shard's length.  Counts (int64) and min/max match exactly (NaN equal to NaN, and a
   group holding a NaN must give NaN); each group's sum within 1e-5 *
   sum(|v|) over the group.  Then the segment kernel (``ops/segments.py``
   ``segment_reduce``) against its plain version: SUM, MIN and MAX of bool,
   int32, int64, float32 and float64 at 1, 16, 17, 64 and the card's gate
   (``onehot_max_segments``) segments at 65,536 rows and at the mesh's
   shard lengths (1,048,576 and 16,777,216 rows), and at 17 (query (a)'s,
   the one count the SQL path gives it there) at ``--rows``, with
   ids outside the range, an empty segment, NaN of either sign and wrapping
   integer sums; integers, MIN and MAX exact, float sums within 1e-9 *
   sum(|x|) over the segment (float32 also one float32 ulp).  Each kernel is
   timed at the SQL path's shape two ways: ``ms``, the median over single
   CUDA-event-timed calls (host work of the wrapper included), and
   ``device_ms``, events around 20 back-to-back calls over 20; and both at
   one 65,536-row chunk (``chunk`` in the JSON line).  Then the wide dense
   GROUP BY kernel (``ops/csrc/dense_agg.cu`` through ``ops/hashagg.py``
   ``dense_group_agg``) against ``dense_group_agg_plain`` on the card at
   the shapes of ``baikaldb_tpu_torch/bench/dense_wide.py``: TPC-H SF1's
   q10 (6M rows, 2% live, 150,001 slots, SUM + 6 MIN) and q18's inner
   GROUP BY (6M rows all live, 6,000,001 slots, runs of ~4, SUM):
   ``present``, counts, integers and MIN/MAX exact, float64 sums within
   1e-12 relative, one launch a call; each timed as ``ms`` and
   ``device_ms`` beside the plain version, the library passes it replaces
   and ``bound_ms`` (its bytes over 3.35 TB/s).  With
   ``--compare-with DIR`` (a checkout of another commit, e.g. from
   ``git archive``), that commit's kernels are timed too, in turns with
   this one's (theirs, ours, ours, theirs): K1-K3 and the segment kernel
   here, their lane entries in phase 12 (iv), and the profiled 64-lane
   ticks of phase 12 (iii) with its lane entries swapped in.
3. SQL: ``Session(device="cuda")`` over ``--rows`` rows (default 100M, the
   BASELINE.json size) of ``t (g INT, v FLOAT, w DOUBLE, g16 INT)``:
   (a) the bench headline over 16 groups (eight segment-kernel launches and
   no ``index_add_``, by the counters and the profiler's kernel names),
   (b) the same over 2048 groups (K3 + K2), (c) SUM/AVG of a DOUBLE over
   2048 groups (K1, and K3 for the groups present).  Each result is checked
   against numpy in float64, and the kernels' launch counters must show that
   each query went through its kernels.
   Each query's warm wall time (median and 67th percentile of 30 runs,
   rows/s at the median) is printed beside its device time from one run
   under torch.profiler (kernels and copies) and the top kernels; load
   time and peak device memory beside them.
4. Streamed scans (exec/streaming.py): on a fresh ``Database`` over the
   same ``--rows`` rows, queries (b) and (c) fold chunk by chunk (65536-row
   chunks, the default), checked against numpy as in phase 3; every kept
   chunk must launch K3 + K2 once for (b) and K1 once for (c),
   ``stream_chunks`` must equal the chunk count and
   ``swallowed.session.stream_stage`` must stay 0 (no silent fall-back to
   the resident path).  Per query: the first run (the chunk-set build
   included for (b)), the warm wall time (median of 2 runs), device time
   and idle share of one profiled run (at 1M-row chunks only: a 65536-row
   run's trace loses kernel records), the ``stream`` trace event
   (``stage_ms``, ``prefetch_wait_ms``, ``bytes_h2d``) and the peak device
   memory; then (b) again at ``streaming_chunk_rows = 1048576``.  Phase 3
   sets ``streaming_scan = 0`` so its numbers stay those of the resident
   path.
5. TPC-H (``baikaldb_tpu_torch/models/tpch.py``): (i) the tables at SF 0.05
   (seed 0) go into ``Session(device="cuda")`` and ``Session(device="cpu")``;
   all 22 queries and ``VARIANTS`` (q20's shape with rows) run on both and
   must agree by the parity contract of ``models/parity.py``; the wide
   dense GROUP BY kernel must launch there (its float64 answers held to
   the CPU's at rtol 1e-9).  (ii) At ``--tpch-scale`` (default 1.0, the smallest
   official scale: 6M lineitem rows; seed ``--seed``) on the card: generation
   time, load + stage time and peak device memory; per query the warm wall
   time (median and 67th percentile of 6 runs after one warm-up run, 2
   when the query streamed), the
   device time, idle share and top 4 kernels of one torch.profiler run, the
   session's spans of one traced run (host milliseconds of parse, plan,
   execution and egress), and the launches of K1-K3, of the segment
   kernel and of the wide kernel per query (reported; the wide kernel's
   sum over the 22, ``wide_launches``, must be above 0).
   q1 and q6 are checked against numpy in float64 (rtol 1e-9), and every
   query must return finite values.
6. Analytics (``baikaldb_tpu_torch/models/analytics.py``: window functions,
   APPROX_COUNT_DISTINCT / MEDIAN / PERCENTILE and the extended builtins
   over the TPC-H tables): (i) on the SF 0.05 tables of phase 5 (i), card
   against CPU by the parity contract; (ii) on the ``--tpch-scale`` tables of
   phase 5 (ii), in the same session, timed as the TPC-H queries are, with
   the launches of K1-K3 over the phase (0: these queries do not reach the
   group-by kernels) and its peak device memory; W-rank and the A-sketch
   queries are held to numpy (``analytics.check_against_numpy``).  The
   phase's seconds are printed on a line of their own.
7. TPC-H q1 and q6 at ``--tpch-scale`` streamed against resident, in turns
   (5 runs each) in phase 5 (ii)'s session, the rows equal by the parity
   contract.
8. Egress and the catalog: FORMAT, DATE_FORMAT, HEX, BIN and OCT of numbers
   over phase 5 (i)'s tables, then CREATE / DROP DATABASE, USE, CREATE / DROP
   VIEW, DESCRIBE, the catalog SHOW forms, TRUNCATE, DROP TABLE and SELECT
   ... INTO OUTFILE, each on the card and on the CPU; rows (and the files)
   equal.
9. Vectors (VECTOR columns, the distance functions, ``index/annindex.py``,
   ``ops/vector.py``): (i) the docs table (a NULL vector) and 8,000
   clustered VECTOR(16) rows with an ANN INDEX (``ann_min_rows`` = 512),
   inserted through INSERT into a card and a CPU session: L2 / COSINE /
   INNER_PRODUCT top-k with and without WHERE and the ANN path, rows equal
   by the parity contract, EXPLAIN equal and showing ``ann(a nprobe=8)``,
   the ANN recall@10 against numpy at least 0.95.  (ii) BASELINE config #4:
   ``vt (id BIGINT, tag INT, emb VECTOR(128))``, 1,000,000 rows from
   ``bench/ann.py``'s generator (``--seed``), ``tag`` in [0, 10), loaded as a
   fixed-size list column (load time, peak memory); V-l2, V-where (``tag =
   3``), V-cos, V-ip (DESC) for 32 query vectors, LIMIT 10, each equal to
   numpy's top-10 in order (numpy's distances in the planner's component
   order and dtypes), then V-ann after ``ALTER TABLE vt ADD ANN INDEX``
   (recall@10 at least 0.95): per shape the first query (V-ann's trains
   k-means; its spans), the other vectors' p50, the warm wall p50 / p67 of
   10 runs, device ms, idle share, device ops and top kernels of one
   profiled run, the spans and the launches; the segment kernel must launch
   (k-means' counts).  (iii) ``brute_force_topk`` (bf16, f32), ``kmeans``
   (1000 clusters, 10 iterations) and ``ivf_topk`` (nprobe 8) on the card:
   device ms against the byte bound, top-10 against numpy within each
   precision's score error, k-means seconds, ivf recall@10 at least 0.95.
   (iv) ``COUNT(*) ... WHERE L2_DISTANCE(emb, q) < r`` with the default
   flags (it streams), against numpy.

10. The mesh (``parallel/``, ``plan/distribute.py``): ``Session(mesh=
   make_mesh(8))`` over the database of another session, every table
   sharded 8 ways (on a one-card machine all on ``cuda:0``) before any query
   is timed.  (i) Right after phase 3, over its 100M-row table (shards of
   16,777,216 rows, the JAX package's rule: BASELINE.json config #2's 8
   regions): (a)-(c) checked against numpy as in phase 3; (b) must launch
   K3 + K2 and (c) K1 + K3 once a shard, (a) the segment kernel 7 times a
   shard and no ``index_add_``, each shard's launches read around its own
   partial and none outside the partials; per query the warm
   wall p50 / p67 of 10 runs, the device time, idle share and top kernels
   of one profiled run (device activity only).  (ii) After phase 7, over
   phase 5 (ii)'s tables: the 22 TPC-H queries and ``q20_rows`` equal to the
   single-device session's rows by the parity contract (rtol 1e-4 where a
   float group-by kernel ran on either side), then q3 with
   ``mpp_force_shuffle = 1``, whose plan must execute at least one
   repartition round, equal too; each timed (5 warm runs, one profiled run)
   with its executed rounds and launches (K3 counts every repartition's
   destinations, once a shard).  Peak device memory of each part and the
   phase's seconds (``mesh phase seconds: ...``).
11. The HTAP write path (regions, the native row engine and its WAL, MVCC,
   transactions; it prints ``row engine: native (...)`` and fails on any
   other engine).  (ii) Right after phase 10 (i), in phase 3's session over
   its 100M rows (``streaming_scan = 0``): session A pins
   (``SET SNAPSHOT = 'now'``); session B deletes ``g = 5``, updates ``v`` and
   ``w`` where ``g = 7`` and inserts 10,000 rows in one transaction, and
   commits.  A's (a)-(c) must equal phase 3's numpy references over a
   versioned batch (``versions_scanned`` > 0), B's the numpy of the rows
   after the writes; each query launches exactly phase 3's kernels and (a)
   no ``index_add_``.  Timed: each statement of B, the re-stage after the
   commit, per query the first run (its ``mvcc.visibility`` span), the warm
   p50 / p67 of 10 runs, device ms and idle share; peak memory.  (i) After
   phase 9: sysbench ``oltp_read_write`` (``models/sysbench.py``) over
   BASELINE.json config #1's 1M-row ``sbtest1`` (regions of 4,096 rows),
   100 transactions of 18 statements in BEGIN ... COMMIT, every SELECT equal
   to a numpy replay, then COUNT(*), SUM(k) and 1,000 sampled rows equal to
   it; transactions/s, p50 / p99 per statement kind, device ms and idle
   share of 5 profiled transactions; then ``SELECT COUNT(*) ... WHERE k
   BETWEEN`` under an automatic pin while a second session commits a
   transaction right after the pin: the answer at the pin, over a
   versioned batch.  (iii) ``Database(data_dir=...)`` on the card: 100,000
   sysbench rows through the WAL (INSERT ... SELECT), 20 transactions and a
   rolled-back one, no checkpoint; a new Database over the directory gives
   the same rows and GROUP BY; then a checkpoint, 20 more transactions, and
   recovery again, equal to the replay.  Its seconds: ``htap phase
   seconds: ...``.

12. Dispatch (the plan cache, PREPARE / EXECUTE, EXPLAIN ANALYZE, the
   batched dispatcher, ``exec/{dispatch,lanes}.py``), right after phase 10
   (i), in phase 3's session over its unchanged 100M rows
   (``streaming_scan = 0``).  (iv) K1, K2, K3 and the segment kernel with a
   lane axis (``*_lanes``: one launch over G masks; each kernel carries a
   tile of lanes a block) against their plain versions (the
   per-lane loops; five lanes at 100M rows x 64) and every lane against the
   one-lane kernels at ``--rows`` rows with G = 8 and 64 and at 10,000,019
   rows with G = 64 (and G = 8 at 4 slots): an all-dead lane, a lane of one live row, NaN in
   MIN/MAX, a group of more than 2^24 rows in every lane; counts and
   MIN/MAX exact, sums as in phase 2, every segment-kernel lane
   bit-identical to the one-lane kernel; then the tiles' edges
   (``lane_edge_cases``: the segment kernel's private, warp and block
   tables at 17, 2,048 and 16,384 slots, K1/K3 at 2049 and K2 at 37, 2049
   and 4096, over lane counts around each tile and 63-65, ragged row
   counts; K2 also with every code in one slot and at D-b's masks); timed
   at 100M rows x 8 and x 64 and at 10,000,019 x 64 against the byte bound
   (the G masks plus one read of codes and values), the plain versions and
   the library call in chunks of 8 lanes beside them but at 100M x 64,
   K2 also at D-b's masks (about 2% live) and with the bytes a call
   allocates.  (i) (a)-(c)
   with 30 literal variants of the WHERE threshold, the plan cache on and
   with ``plan_cache_size = 0`` (warm p50 / p67, the ``plan.*`` spans of a
   traced pass, the counter deltas), every variant against float64
   references (sorted per-group prefix sums, ``ThresholdRefs``); after phase 10 (ii), the
   host-bound TPC-H queries at SF1 with the cache on and off, their rows
   equal.  (ii) (b) PREPAREd with a ``?`` threshold and EXECUTEd with 20
   values, against numpy.  (iii) 64 sessions on 64 threads behind a barrier,
   each sending 4 statements (8 until PR 15) of D-a (17 slots: the segment kernel), D-b
   (ranges of at most 100 groups of 2049 slots: K3 + K2; one client's range
   holds 200 groups, past the 128-row scatter budget) and D-c (K1 + K3),
   each with its own literals, against the same 512 statements one after
   another on one session (256 a shape): every client's rows equal its serial run bit for
   bit and numpy; each tick launches each lane kernel exactly as
   ``D_TICK_LAUNCHES`` says, the inline runs exactly the one-lane kernels,
   ``dispatch_fallbacks`` at most the overflowed lanes; serial and
   concurrent walls, statements/s, p50 / p99, ticks and the occupancy
   histogram, queue-wait p50, one tick of the 64 clients' first statements
   profiled through the lane program (device ms, K2's device ms, idle
   share), peak memory.
   (v) EXPLAIN ANALYZE of (a)-(c): the scan's and the aggregate's live rows
   equal numpy's, the ``-- dispatch`` and ``-- params`` lines present, the
   D shapes' literals hoisted (``pinned=0``).  ``dispatch phase seconds``.

13. Partitions and the session surface.  (i)-(v) Right after phase 12, in
   phase 3's session beside its unchanged ``t`` (``streaming_scan = 0``):
   ``tp``, the same ``--rows`` rows declared ``PARTITION BY RANGE (g)`` in 8
   partitions of 256 values (the last MAXVALUE), loaded through the bulk
   ingest (load seconds, regions).  (a-p)-(c-p) are (a)-(c) with ``g >= 512
   AND g < 1024``: EXPLAIN shows ``partition(5/8 partitions pruned)`` (the
   reference's closed-range rule keeps p2-p4), the rows equal numpy and
   the same SQL over ``t``, and each launches exactly (a)-(c)'s kernels
   once over the pruned batch (``EXPECTED_LAUNCHES``; the batch holds
   p2-p4's rows); per query the first run ((a-p) stages the pruned batch), the
   warm p50 / p67 of 30 runs, device ms and idle share, and the same SQL's
   over ``t``.  K1, K2, K3 and the segment kernel against their plain
   versions on the pruned batch's own codes, values and masks (phase 2's
   tolerances), each timed there against its byte bound.  ``ALTER TABLE
   tp DROP PARTITION p2``, timed, then (b-p) against numpy without p2's
   rows.  (vi) After phase 11: sysbench's 1M rows twice, ``sbtest1`` (KEY
   k_1) and ``sbg`` (k_1 a GLOBAL INDEX): 100 point selects ``WHERE k = ?``
   through ``global_index(k_1:k)`` equal sbtest1's, 100 UPDATE-k / DELETE /
   INSERT pairs on both, then sbg's backing table equals its (k, id)
   projection; p50 / p99 of each kind.  (vii) After phase 12's TPC-H part:
   MATCH ... AGAINST over the SF ``--tpch-scale`` ``orders`` (a COUNT and a
   boolean-mode top 10 by relevance), equal to a CPU session's rows; first
   (the index builds) and warm p50 ms.  (viii) The session surface (the
   environment, SHOW, the ``information_schema`` tables, HANDLE, a LOAD
   DATA round trip of 250,000 rows through INTO OUTFILE) on a CUDA and a
   CPU ``Session``, equal.  ``partition phase seconds``.
14. The lifecycle plane (storage/binlog.py, cdc/, index/rollup.py,
   meta/ddl.py, TTL).  (i)-(iii) Right after phase 11 (ii), in phase 3's
   session over ``t`` as those writes left it (``streaming_scan = 0``; the
   numpy state is phase 11's columns with each later write applied), under
   ``CREATE SUBSCRIPTION feed ON t``.  (i) The same SQL warm (p50 / p67 of
   30) with no rollup, then ``ALTER TABLE t ADD ROLLUP`` r_g (g, AGGREGATE(v)),
   r_g16 (g16, AGGREGATE(v)) and r_gw (g, AGGREGATE(w)): EXPLAIN names each
   rollup table; each query's first answer (its refresh over the table, with
   the kernels it launched) and warm p50 / p67; an INSERT of 1,000 rows, and
   each next answer's refresh; every answer against numpy (sums within
   1e-5 * sum|v|, counts and MIN exact).  (ii) ``CREATE MATERIALIZED VIEW mv AS
   SELECT g16, COUNT(*), SUM(g), MIN(g), MAX(g) FROM t GROUP BY g16``: the
   seed (the first answer), then rounds of an INSERT of 500 rows, a DELETE
   and an UPDATE of k < 1,000 rows, a DELETE of rows holding a group's MIN
   (a group rescan) and a DELETE of ~49,000 rows (a statement image: a full
   re-seed), each answer (fold + answer) timed and equal to numpy and to
   ``matview_answer = 0`` bit for bit; ``staleness_ms``, ``deltas_folded``,
   ``rescans``.  (iii) ``FETCH 1 FROM feed`` until empty: each event's kind,
   affected count and row images equal the statements (numpy); FETCH's p50.
   K1-K3 and the segment kernel against their plain versions on the
   refreshed table's batch (and the segment kernel over g as the view's
   integer SUM / MIN / MAX), timed there.  Phase 11 (iii)'s ``data_dir``
   also holds a subscription and a view on sbtest1: reopened, the same
   un-acked events and the view's answers come back.  (iv) sysbench's 1M
   rows without k_1: ``ALTER TABLE sbtest1 ADD INDEX k_1 (k)`` while a second
   session updates k by primary key, seconds to publish, EXPLAIN full before
   and ``index(k_1:k)`` after, the rows equal to the replay; then ``ADD
   GLOBAL INDEX gk (k)``, its backfill's seconds and the point selects'
   p50 / p99 through ``global_index(gk:k)``.  (v) ``ev (id BIGINT PRIMARY
   KEY, ts DATETIME, v INT) TTL=3600 TTL_COLUMN=ts``, 10M rows, 30% expired:
   HANDLE ttl timed, the rows left equal numpy, the binlog holds the purge.
   ``lifecycle phase seconds``.
15. Live-query introspection, KILL, SHOW STATUS / PROFILE, the flight
   recorder and users (obs/, meta/privileges.py).  (i) Right after phase 3,
   in its session over its unchanged rows: (a)-(c) warm in 3 alternating
   turns of 10 runs with ``progress_tracking = 1`` and ``= 0`` (p50 / p67,
   each turn's p50, one profiled run a side: device ms and idle share);
   SHOW STATUS around one run of each: the ``kernel_launches.*`` deltas
   equal phase 3's launches, ``query_latency`` moves by the query and the
   SHOW before it, ``device_hbm_in_use_bytes`` equals
   ``torch.cuda.memory_allocated()`` and ``device_hbm_limit_bytes`` the
   card's memory; (b) under ``slow_query_ms = 1`` and tracing leaves a
   flight record whose bundle holds its plan, spans and the card's memory
   stats; SHOW PROFILE's root of (b) within 10% of the client's wall
   (median of 5); ``CREATE USER app``: (c) as app raises AccessError before
   any launch, after ``GRANT SELECT ON default.*`` it gives numpy's rows
   with K1 1, K3 1; the access check's host ms.  (ii) In phase 4's session:
   (b) streamed (1,526 chunks) on a worker thread while a second session
   polls ``information_schema.processlist`` every 50 ms (``operator``
   ``StreamScan(default.t)``, ``chunk_no`` never down); at chunk 763 it
   KILLs the query: the worker raises QueryKilled (the kill latency from
   KILL's return, the chunks folded after it, the K2 / K3 launches before
   it), then no ``stream-prefetch`` thread, ``memory_allocated`` at its
   level before the query, an empty processlist, no watchdog stall, a
   ``killed`` flight record with a bundle; the next (b) gives numpy's rows
   with one streamed run's launches.  (iii) After phase 12 (iii), in phase
   3's session: 16 D-b clients through the dispatcher (20 ms tick), 4 of
   them KILLed while SHOW PROCESSLIST shows them in ``exec.queued``: a
   killed client raises QueryKilled (or returns its serial rows had its
   tick taken it), every other client returns its serial rows bit for bit;
   the ticks and their lane launches.  ``observability phase seconds``;
   each kernel's launches here are ``launches_observability``.
16. The radix join, the host presort and the replicated tier.  (i) After
   phase 13 (vii), in phase 5 (ii)'s session: every TPC-H query's plan
   nodes that take a presort (``__presort__`` batches; q3, q10, q18 and
   q21 listed either way); each such query with and without its presort
   (the ``__presort__`` keys stripped, the JAX package's own method) in 3
   alternating turns (10 warm runs a side, p50 / p67 and each turn's p50),
   the first run after the permutations are dropped and the host argsort
   alone, one profiled run a side; both sides' rows equal phase 5 (ii)'s.
   Then ``radix_join_buckets = 256``: q3 (all its joins are dense: none
   takes the radix path) and q13, whose LEFT JOIN takes it with the
   presort stripped (the gate refuses a presorted build): the joins and
   their widths, q13 against the sort join in alternating turns, rows
   equal, and ``radix_join`` alone against ``join`` alone at that build,
   in device ms.  (ii) At the end: BASELINE.json config #2 deployed as
   3-replica Raft groups, ``MetaService(peer_count=3)`` and a
   ``StoreFleet`` of 3 stores: ``tr (id BIGINT PRIMARY KEY, g INT, v FLOAT,
   w DOUBLE, g16 INT)``, 2^18 rows of phase 3's generator (cut from 10M:
   ~70 us a replicated row of host work; 2^20 split at 262,144 before
   phase 17 came, then 2^19), loaded through Raft (seconds, rows/s), then
   split at ``region_split_rows`` = 65,536 into 8 regions (phase 17's size)
   (seconds apart); SHOW REGIONS and ``information_schema.regions`` (8
   regions, their leaders); (a)-(c) over ``tr`` with phase 3's launches,
   against numpy; 200 single-row autocommit writes (1PC; p50 / p99 beside
   the same statements on a plain ``Session(device="cuda")``), 20
   transactions over the first and the last region (one 2PC each) and a
   rollback; ``kill_store`` of the store leading the most regions, 20
   writes (the first one's latency); a fresh ``Database(fleet=...)``
   rebuilt from the replicas: seconds, its rows equal a numpy replay of
   every acknowledged write, its (a)-(c) launch phase 3's kernels and equal
   numpy, K1-K3 and the segment kernel against their plain versions on its
   batch; ``memory_allocated`` and the peak; ``revive_store``.  ``replicated
   phase seconds``; each kernel's launches in (ii) are
   ``launches_replicated``.

17. The network plane: BASELINE.json config #2 on a 3-store TCP cluster.
   ``tools/deploy_cluster.spawn_cluster`` starts 1 meta and 3 store daemon
   processes (free ports, ``CUDA_VISIBLE_DEVICES`` empty, one cold
   directory shared with the frontends).  Frontend A,
   ``Session(Database("cuda", cluster=meta))``, creates ``tr`` (phase 16
   (ii)'s DDL) and loads 2^18 rows of phase 16's generator over TCP in
   32,768-row writes, each region split when it reaches
   ``region_split_rows`` = 65,536 (8 regions of 32,768; load rows/s, split
   seconds apart).  With
   ``pushdown_reads = always``: (a)-(c) as fragments folded on the stores'
   hosts (the first run and 3 warm ones, ``fragments_dispatched``,
   ``fragment_bytes_saved``, ``fragment_warm_compiles`` on re-dispatch:
   0), rows against numpy under the row-wise (float64) predicate.  A
   second frontend B under ``auto``: its first (a) pushed with the table
   unattached (one run), then the attach (the full pull over TCP and the stage,
   seconds), then its warm (a)-(c) on the card (p50 / p67, device ms, idle
   share, launches, counts set to 0 just before: ``launches_cluster``) and
   K1-K3 and the segment kernel against their plain versions on B's image
   (the ``cluster`` entry of each kernel).  Through A: 100 single-row
   writes (1PC, p50 / p99) and 20 two-region transactions (2PC, p50 /
   p99): a commit waits for the daemons' 50 ms raft tick; HANDLE
   cold_flush, (a) pushed again, one run, with ``fragment_fallbacks``
   unchanged (the daemons fold their cold segments in place), cold_gc.  A BINLOG=1 table written by
   both frontends (8 writes, then 4 after the kill) and read by one
   ``BinlogCapturer`` as one commit-ts-ordered stream (events/s, p50 of a
   poll); SIGKILL of the store leading the most regions, the first write
   after it and the capturer losing no event; a fresh frontend C rebuilds
   hot + cold (seconds; rows equal the numpy replay of every acknowledged
   write); ``information_schema.cluster_metrics`` rows from every live
   daemon; ``nvidia-smi --query-compute-apps=pid`` lists two processes (this
   one and phase 18 (ii)'s frontend process, which has loaded libcuda), and
   every live daemon runs with ``CUDA_VISIBLE_DEVICES`` empty and has not
   loaded libcuda (the daemons never import torch).  ``cluster phase seconds``.
18. The MySQL wire and the chaos scenarios (server/mysql_server.py,
   client/mysql_client.py, chaos/scenarios.py).  (i) Right after phase 15
   (i), in phase 3's session over its unchanged rows (``streaming_scan =
   0``): an in-process ``MySQLServer`` on its Database.  (a)-(c) in the
   session (10 warm runs each, p50 / p67), then, counters at 0, from a wire
   ``Connection``: each query's first run launches exactly phase 3's
   kernels, its rows equal numpy and the session's (keys and counts exact,
   the rest to rtol 1e-4), 10 warm runs (p50 / p67); 8 ``Pool`` connections
   each EXECUTE a prepared D-a 4 times behind a barrier (tick 20 ms): every
   answer equal numpy, the segment kernel's lane entry launched; a wire
   client running (b) KILLed by KILL CONNECTION from another at its
   ``egress.arrow`` beat (its kernels ran, its result is on the card, above
   the memory before the query): its client sees the socket closed, its
   connection leaves the processlist, ``memory_allocated`` is back at its
   level before the query.
   (ii) Inside phase 17, after frontend B's queries: the frontend process
   ``spawn_cluster(mysql_port=...)`` started with the daemons (``python -m
   baikaldb_tpu_torch.server --meta ...`` on the card) pulls ``tr`` (the
   CREATE under ``pushdown_reads = 'off'``, timed) and answers (a)-(c) over
   the wire, equal to B's rows and numpy, launching (by its SHOW STATUS)
   phase 3's kernels a run.  (iii) After phase 17: the ten scenarios of
   ``chaos/scenarios.py`` through ``run_scenario(name, --seed,
   device="cuda")`` at their defaults, each ``ok``, the five fleet-plane
   ones twice with equal schedules and digests; then ``stream_chaos`` over
   262,144 rows in 16,384-row chunks: every pass folds 16 chunks and equals
   the resident answer.  Seconds of each scenario; the launches of (i) and
   (iii) are ``launches_wire`` / ``launches_chaos`` in the kernels line.
   ``wire phase seconds``.
19. The analysis plane's runtime guards (analysis/runtime.py).  (i) Right
   after phase 18 (i), in phase 3's session over its unchanged rows
   (``streaming_scan = 0``): (a)-(c) under ``debug_guards = disallow``, 5
   runs each in turns with 5 at ``off``: 0 transfer, lock and owner trips,
   the rows equal numpy, each run phase 3's launches; the ``host_read``
   calls a query (counted by wrapping it) and p50 on and off.  (iii) Then 8
   threads x 4 prepared D-a through the dispatcher under ``disallow`` with
   the telemetry poller and the watchdog running: 0 owner and 0 rank trips,
   answers equal numpy, the segment kernel's lane entry launched.  (ii)
   After phase 16, in the timed TPC-H session: the 22 queries once each
   under ``log``, the sync warnings a query (caught on this thread, by the
   port's file:line) and its host reads.  The launches of (i) and (iii) are
   ``launches_guards`` in the kernels line.  ``guards phase seconds``.

Phases 5 and 6 run with the default flags, so a query over a table of at
least ``streaming_min_rows`` rows that the streamed path accepts streams
there (q1, q6 and some analytic queries, over lineitem); which ones did is
printed and recorded.

Each phase's seconds are printed on a line of their own, and in the JSON line
of measurements (redirect standard output to keep it), beside the script's
seconds from its start (the kernels' builds included).  The last two
lines of standard output are the ``kernels`` JSON line and the
``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM, float32 outside the tensor cores
F64_OPS_PER_S = 34e12            # H100 SXM, float64 outside the tensor cores
NG_SQL = 2049                    # 2048 dense group slots + the NULL slot
WARM_REPS = 30
TPCH_REPS = 6                    # 10 until PR 8; cut to keep the run near half its limit
STREAM_REPS = 2                  # 3 until PR 8
STREAM_TPCH_REPS = 5
BIG_CHUNK_ROWS = 1 << 20
TPCH_CHECK_SCALE = 0.05
REPLACES = {
    "filtered_group_sum": "baikaldb_tpu/ops/pallas_kernels.py:184",
    "fused_group_aggregate": "baikaldb_tpu/ops/pallas_kernels.py:210",
    "partition_histogram": "baikaldb_tpu/ops/pallas_kernels.py:238",
    "segment_reduce": "baikaldb_tpu/ops/segments.py:50",
}
SOURCES = {"segment_reduce": "baikaldb_tpu_torch/ops/csrc/segments.cu",
           "segment_reduce_lanes": "baikaldb_tpu_torch/ops/csrc/segments.cu"}
# the lane-batched entries of phase 12 and the one-lane kernel each extends
LANE_KERNELS = {"filtered_group_sum_lanes": "filtered_group_sum",
                "fused_group_aggregate_lanes": "fused_group_aggregate",
                "partition_histogram_lanes": "partition_histogram",
                "segment_reduce_lanes": "segment_reduce"}
SEG_DTYPES = (torch.bool, torch.int32, torch.int64, torch.float32, torch.float64)
NG_A = 17                        # query (a): 16 groups + the NULL slot
ODD_SEG_ROWS = 1_000_003         # phase 11's segment cases at an odd length (100M-odd to PR 17)
QUERIES = {
    "a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g16 ORDER BY g16",
    "b": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
         "WHERE v*2+1 > 0.5 GROUP BY g ORDER BY g",
    "c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > -1 GROUP BY g ORDER BY g",
}
EXPECTED_LAUNCHES = {
    # present, COUNT(*), and SUM / AVG / MIN each with its live count
    "a": {"segment_reduce": 8},
    "b": {"partition_histogram": 1, "fused_group_aggregate": 1},
    "c": {"filtered_group_sum": 1, "partition_histogram": 1},
}
MESH_SHARDS = 8
# K2's kernels by name in a profile (not K1/K3's group_agg_*kernel)
K2_KERNEL = re.compile(r"(?<![A-Za-z_])agg_(lanes_)?kernel<|(?<![A-Za-z_])agg_merge\(")
# the main kernel of each wrapper call (K1/K3, K2, the segment kernel; lanes too)
OWN_KERNEL = re.compile(r"(?<![A-Za-z_])(?:group_agg|agg|seg)(?:_lanes)?_kernel<")
# a profiled run that lost device records is profiled again, up to this many
# times; the trace opens and closes this long apart from the run
PROFILE_TRIES = 3
PROFILE_PAD_S = 0.02
# launches of each shard's partial on the mesh: (a)'s AVG shares SUM's partial
MESH_EXPECTED_LAUNCHES = EXPECTED_LAUNCHES | {"a": {"segment_reduce": 7}}
# the wide dense GROUP BY kernel: counted by ``all_launches``, required only
# where a phase says so (the 100M-row queries' slots are under its gate)
WIDE = "dense_group_agg"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def all_launches(gk) -> dict:
    """Launch counts of K1-K3, of the segment kernel and of the wide
    kernel."""
    from baikaldb_tpu_torch.ops import dense_agg
    from baikaldb_tpu_torch.ops import segments as seg

    return {**{k: c.value for k, c in gk.LAUNCHES.items()},
            **{k: c.value for k, c in seg.LAUNCHES.items()},
            **{k: c.value for k, c in dense_agg.LAUNCHES.items()}}


def lane_launches(gk) -> dict:
    """Launch counts of the lane-batched entries (phase 12)."""
    from baikaldb_tpu_torch.ops import segments as seg

    return {k: c.value for k, c in {**gk.LANE_LAUNCHES, **seg.LANE_LAUNCHES}.items()}


def reset_launches(gk) -> None:
    from baikaldb_tpu_torch.ops import dense_agg
    from baikaldb_tpu_torch.ops import segments as seg

    for reg in (gk.LAUNCHES, seg.LAUNCHES, gk.LANE_LAUNCHES, seg.LANE_LAUNCHES,
                dense_agg.LAUNCHES):
        for c in reg.values():
            c.reset()


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed calls,
    after one warm-up call (none with ``warm=False``).  Each call is timed
    alone, so its host work (the wrapper's checks, allocation and launch) is
    in the number."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, launches: int = 20, runs: int = 3) -> float:
    """Device milliseconds per call: CUDA events around ``launches``
    back-to-back calls, over ``launches``, after a warm-up call; the median
    of ``runs`` such windows."""
    fn()
    per_call = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / launches)
    return statistics.median(per_call)


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions

PLUS_NAN = 0x7FC00000                  # numpy's and torch's NaN
MINUS_NAN = -0x00400000                # int32 bits of 0xFFC00000, x86's default NaN
NAN_GROUPS = {5: PLUS_NAN, 9: MINUS_NAN}


def make_inputs(n, ng, gen, dev, *, live=0.6, spread=0, empty=None, masked=False,
                offset=(0, 0, 0), nans=False):
    """Seeded inputs on the card.  ``offset``: codes, values and mask are
    contiguous views at these element offsets of larger tensors.  ``nans``:
    live rows of group 5 get a +NaN and of group 9 a -NaN; a NaN also sits in
    a masked-out row of group 11 and in a row whose code is out of range;
    group 13 holds only +inf and group 17 only -inf."""
    oc, ov, om = offset
    codes = torch.randint(-spread, ng + spread, (n + oc,), generator=gen, device=dev,
                          dtype=torch.int32)[oc:]
    if empty is not None:
        codes = torch.where(codes == empty, empty + 1, codes)
    values = torch.randn(n + ov, generator=gen, device=dev, dtype=torch.float32)[ov:]
    if masked:
        mask = torch.zeros(n + om, dtype=torch.bool, device=dev)[om:]
    else:
        mask = (torch.rand(n + om, generator=gen, device=dev) < live)[om:]
    if nans:
        bits = values.view(torch.int32)
        for i, (g, nan) in enumerate(NAN_GROUPS.items()):
            rows = slice(100 + 10 * i, 103 + 10 * i)
            codes[rows], mask[rows], bits[rows] = g, True, nan
        codes[200], mask[200], bits[200] = 11, False, PLUS_NAN
        codes[201], mask[201], bits[201] = ng, True, PLUS_NAN
        codes[120:123], mask[120:123] = 13, True
        codes[130:133], mask[130:133] = 17, True
        values[codes == 13] = float("inf")
        values[codes == 17] = float("-inf")
    return codes, values, mask


def same(got, want) -> bool:
    """Exact equality, NaN equal to NaN."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))


def check_case(gk, codes, values, mask, ng) -> float:
    """Hold K1-K3 against the plain versions on one input; -> max |err|."""
    live = mask & (codes >= 0) & (codes < ng)
    gid = torch.where(live, codes, ng).to(torch.int64)
    sabs = torch.zeros(ng + 1, dtype=torch.float64, device=codes.device)
    sabs.index_add_(0, gid, values.abs().to(torch.float64))
    tol = 1e-5 * sabs[:ng]
    k1 = gk.filtered_group_sum(codes, values, mask, ng)
    k2 = gk.fused_group_aggregate(codes, values, mask, ng)
    k3 = gk.partition_histogram(codes, mask, ng)
    torch.cuda.synchronize()
    p1 = gk.filtered_group_sum_plain(codes, values, mask, ng)
    p2 = gk.fused_group_aggregate_plain(codes, values, mask, ng)
    p3 = gk.partition_histogram_plain(codes, mask, ng)
    where = f"(ng={ng}, n={codes.shape[0]})"
    for name, counts in (("partition_histogram", k3), ("filtered_group_sum", k1[0]),
                         ("fused_group_aggregate", k2[0])):
        if counts.dtype is not torch.int64:
            raise AssertionError(f"{name} counts are {counts.dtype}, not int64 {where}")
    for name, got, want in (("partition_histogram counts", k3, p3),
                            ("filtered_group_sum counts", k1[0], p1[0]),
                            ("fused_group_aggregate counts", k2[0], p2[0]),
                            ("fused_group_aggregate mins", k2[2], p2[2]),
                            ("fused_group_aggregate maxs", k2[3], p2[3])):
        if not same(got, want):
            raise AssertionError(f"{name} differ from the plain version {where}")
    # a group holding a NaN: MIN and MAX are NaN on the card, asserted
    # directly and not only against the plain version
    nan_rows = live & values.isnan()
    has_nan = torch.zeros(ng + 1, dtype=torch.int64, device=codes.device)
    has_nan.index_add_(0, gid, nan_rows.to(torch.int64))
    has_nan = has_nan[:ng] > 0
    for name, got in (("mins", k2[2]), ("maxs", k2[3]), ("sums", k2[1])):
        if not torch.equal(got.isnan(), has_nan):
            raise AssertionError(f"fused_group_aggregate {name}: NaN where the input has "
                                 f"none, or a NaN lost {where}")
    # K1 also takes DOUBLE columns (contracted as float32)
    k1d = gk.filtered_group_sum(codes, values.to(torch.float64), mask, ng)
    if not torch.equal(k1d[0], p1[0]):
        raise AssertionError(f"filtered_group_sum float64 counts differ {where}")
    err = 0.0
    for name, got, want in (("filtered_group_sum", k1[1], p1[1]),
                            ("filtered_group_sum float64", k1d[1], p1[1]),
                            ("fused_group_aggregate", k2[1], p2[1])):
        ok = torch.isfinite(want)
        if not same(got[~ok], want[~ok]):
            raise AssertionError(f"{name} sums: NaN or inf differs from the plain version "
                                 f"{where}")
        d = (got[ok].to(torch.float64) - want[ok].to(torch.float64)).abs()
        if bool((d > tol[ok]).any()):
            raise AssertionError(f"{name} sums beyond 1e-5*sum|v| {where}: "
                                 f"max diff {float(d.max())}")
        if d.numel():
            err = max(err, float(d.max()))
    return err


def load_port(root: str):
    """``ops/group_kernels`` of the port checked out under ``root`` (another
    commit), imported beside this one under its own package name; its
    kernels build from its own sources into its own ``_build/``."""
    pkg = os.path.join(os.path.abspath(root), "baikaldb_tpu_torch")
    alias = "baikaldb_tpu_torch_compared"
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.ops.group_kernels")


def compared_segments(before):
    """``ops/segments`` of the checkout ``load_port`` imported."""
    return importlib.import_module(before.__name__.rsplit(".", 1)[0] + ".segments")


def in_turns(this, before, timer) -> tuple[float, dict | None]:
    """``timer(this)`` -> (its time, None); with ``before`` (the compared
    commit's function of the same arguments) in turns, the compared one,
    this, this, the compared one -> (this one's mean, both pairs)."""
    if before is None:
        return timer(this), None
    b1, t1, t2, b2 = (timer(f) for f in (before, this, this, before))
    return (t1 + t2) / 2, {"before": [b1, b2], "this": [t1, t2]}


def kernel_phase(gk, rows: int, seed: int, before=None) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    libs = gk.build_all()
    log(f"[kernels] built {libs} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    max_err = 0.0
    # the streamed path launches at its chunks' shapes: 65,536 rows (the
    # default chunk), 1,048,576 (phase 4's large chunks) and ragged tails
    chunk = 1 << 16
    big = BIG_CHUNK_ROWS
    cases = [(rows, NG_SQL, {}), (chunk, NG_SQL, {}), (rows % chunk or chunk, NG_SQL, {}),
             (big, NG_SQL, {}), (rows % big or big, NG_SQL, {}),
             (1 << 24, 513, {}), (1 << 24, 2049, {}),
             (1 << 24, 4096, {}), (1_000_003, 513, {}), (1_000_003, 2049, {}),
             (1_000_003, 4096, {}), (777_777, 4096, {"spread": 5, "empty": 17}),
             (123_457, 2049, {"masked": True}), (3, 4096, {}), (0, 600, {}),
             (1_000_003, 2049, {"nans": True}), (1 << 20, 700, {"nans": True}),
             (1_000_003, 2049, {"offset": (0, 1, 0)}),
             (1_000_002, 2049, {"offset": (0, 2, 0)}),
             (1_000_001, 2049, {"offset": (0, 3, 0)}),
             (1_000_001, 4096, {"offset": (1, 1, 1)}),
             (999_999, 513, {"offset": (3, 3, 3), "nans": True}),
             (1_000_003, 2049, {"offset": (2, 0, 1)}),
             # the mesh's exchanges count 8 destinations at a shard's length:
             # 16,777,216 rows (phase 10's (a)-(c)), 1,048,576 (TPC-H lineitem)
             (1 << 24, MESH_SHARDS, {}), (1 << 20, MESH_SHARDS, {})]
    for n, ng, kw in cases:
        max_err = max(max_err, check_case(gk, *make_inputs(n, ng, gen, dev, **kw), ng))
        log(f"[kernels] n={n} ng={ng} {kw or ''}: match")
    # one group of 2^24 + 1 rows: a float32 count would give 2^24
    big_group = (1 << 24) + 1
    codes = torch.zeros(big_group + 3, dtype=torch.int32, device=dev)
    codes[big_group:] = torch.tensor([1, 2, 7], dtype=torch.int32, device=dev)
    values = torch.ones(big_group + 3, dtype=torch.float32, device=dev)
    mask = torch.ones(big_group + 3, dtype=torch.bool, device=dev)
    want = [big_group, 1, 1, 0, 0, 0, 0, 1]
    for name, counts in (("K1", gk.filtered_group_sum(codes, values, mask, 8)[0]),
                         ("K2", gk.fused_group_aggregate(codes, values, mask, 8)[0]),
                         ("K3", gk.partition_histogram(codes, mask, 8))):
        if counts.dtype is not torch.int64 or counts.tolist() != want:
            raise AssertionError(f"{name} counts {counts.tolist()} != {want}")
    max_err = max(max_err, check_case(gk, codes, values, mask, 8))
    log(f"[kernels] one group of {big_group} rows: exact int64 counts")
    del codes, values, mask

    # times at the SQL path's shape
    codes, values, mask = make_inputs(rows, NG_SQL, gen, dev)
    w64 = values.to(torch.float64)        # query (c) feeds K1 a DOUBLE column
    live = int((mask & (codes >= 0) & (codes < NG_SQL)).sum())
    gid = torch.where(mask, codes, NG_SQL).to(torch.int64)
    ones = torch.ones(rows, dtype=torch.float32, device=dev)
    acc32 = torch.zeros(NG_SQL + 1, dtype=torch.float32, device=dev)
    acc64 = torch.zeros(NG_SQL + 1, dtype=torch.float64, device=dev)
    specs = {
        # name: (kernel arguments, library call or None,
        #        bytes the function must move, operations per live row)
        "filtered_group_sum": ((codes, w64, mask, NG_SQL),
                               lambda: acc64.index_add_(0, gid, w64),
                               rows * 5 + live * 8 + NG_SQL * 8, 2),
        "fused_group_aggregate": ((codes, values, mask, NG_SQL), None,
                                  rows * 5 + live * 4 + NG_SQL * 16, 4),
        "partition_histogram": ((codes, mask, NG_SQL),
                                lambda: acc32.index_add_(0, gid, ones),
                                rows * 5 + NG_SQL * 4, 1),
    }

    c_codes, c_values, c_mask = make_inputs(chunk, NG_SQL, gen, dev)
    chunk_args = {"filtered_group_sum": (c_codes, c_values.to(torch.float64), c_mask, NG_SQL),
                  "fused_group_aggregate": (c_codes, c_values, c_mask, NG_SQL),
                  "partition_histogram": (c_codes, c_mask, NG_SQL)}

    def timed(mod, name, args):
        fn = getattr(mod, name)
        return cuda_ms(lambda: fn(*args), 20), device_ms(lambda: fn(*args))

    out = {}
    for name, (args, lib, nbytes, ops) in specs.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = live * ops / F32_OPS_PER_S * 1e3
        if before is None:
            ms, dev_ms = timed(gk, name, args)
        else:
            # in turns: the compared commit, this one, this one, the compared one
            b1, t1, t2, b2 = (timed(m, name, args) for m in (before, gk, gk, before))
            ms, dev_ms = (t1[0] + t2[0]) / 2, (t1[1] + t2[1]) / 2
        plain = getattr(gk, f"{name}_plain")
        out[name] = {
            "ms": ms,
            "device_ms": dev_ms,
            "plain_ms": cuda_ms(lambda: plain(*args), 5),
            "library_ms": None if lib is None else cuda_ms(lib, 5),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": max_err,
        }
        # one launch at the streamed path's chunk shape: what each kernel
        # costs per chunk of a fold
        c_ms, c_dev = timed(gk, name, chunk_args[name])
        out[name]["chunk"] = {"rows": chunk, "ms": c_ms, "device_ms": c_dev}
        if before is not None:
            out[name]["before"] = {"ms": [b1[0], b2[0]], "device_ms": [b1[1], b2[1]],
                                   "this_ms": [t1[0], t2[0]],
                                   "this_device_ms": [t1[1], t2[1]]}
        log(f"[kernels] {name}: {ms:.4f} ms a call, {dev_ms:.4f} ms on the device "
            f"(plain {out[name]['plain_ms']:.4f} ms, bound {out[name]['bound_ms']:.4f} ms) "
            f"at n={rows} ng={NG_SQL}; {c_ms:.4f} / {c_dev:.4f} ms at a {chunk}-row chunk"
            + ("" if before is None else
                                          f"; compared commit {out[name]['before']}"))
    return out


def seg_inputs(n: int, S: int, dtype, gen, dev):
    """Seeded inputs of the segment kernel on the card: ids in [-2, S + 2)
    (outside [0, S) they drop), segment 3 emptied when S > 4; floats carry
    +NaN in segment 1 and -NaN in segment 2 (and a NaN in a dropped row)
    when S > 2; integers span half their range, so sums wrap."""
    gid = torch.randint(-2, S + 2, (n,), generator=gen, device=dev, dtype=torch.int32)
    if S > 4:
        gid = torch.where(gid == 3, 4, gid)
    if dtype is torch.bool:
        x = torch.rand(n, generator=gen, device=dev) < 0.5
    elif dtype.is_floating_point:
        x = (torch.randn(n, generator=gen, device=dev, dtype=torch.float64) * 1e3).to(dtype)
        if S > 2 and n > 40:
            bits = x.view(torch.int32 if dtype is torch.float32 else torch.int64)
            pos, neg = ((PLUS_NAN, MINUS_NAN) if dtype is torch.float32
                        else (0x7FF8000000000000, -0x0008000000000000))
            gid[10:13], bits[10:13] = 1, pos
            gid[20:23], bits[20:23] = 2, neg
            gid[30], bits[30] = S, pos
    else:
        info = torch.iinfo(dtype)
        x = torch.randint(info.min // 2, info.max // 2, (n,), generator=gen, device=dev,
                          dtype=dtype)
    return x, gid


def seg_check(seg, x, gid, S: int, op: str, got=None) -> float:
    """The segment kernel (or ``got``, a lane of the lane kernel) against
    the plain version on one input: integers, MIN and MAX exact (NaN equal
    to NaN); float sums within 1e-9 * sum(|x|) over the segment (float32
    also one float32 ulp); -> max |err|."""
    if got is None:
        got = seg.segment_reduce(x, gid, S, op)
    torch.cuda.synchronize()
    want = seg.segment_reduce_plain(x, gid, S, op)
    where = f"({op} {x.dtype} S={S} n={x.shape[0]})"
    if got.dtype != want.dtype or got.shape != (S,):
        raise AssertionError(f"segment kernel output {got.dtype}{tuple(got.shape)} {where}")
    if op != "sum" or not x.dtype.is_floating_point:
        if not same(got, want):
            raise AssertionError(f"segment kernel differs from its plain version {where}")
        return 0.0
    live = (gid >= 0) & (gid < S)
    sabs = torch.zeros(S + 1, dtype=torch.float64, device=x.device)
    sabs.index_add_(0, torch.where(live, gid, S).long(), x.abs().double().nan_to_num(0.0))
    tol = 1e-9 * sabs[:S]
    if x.dtype is torch.float32:
        tol = tol + want.double().abs() * 2.0 ** -23
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"segment kernel NaN differs from its plain version {where}")
    ok = ~want.isnan()
    d = (got[ok].double() - want[ok].double()).abs()
    if bool((d > tol[ok]).any()):
        raise AssertionError(f"segment kernel sums beyond 1e-9*sum|x| {where}: "
                             f"max diff {float(d.max())}")
    return float(d.max()) if d.numel() else 0.0


def segment_cases(seg, n: int, gen, segments=None) -> tuple[float, int]:
    """Every dtype and op at 1, 16, 17, 64 and the gate's segments (or at
    ``segments``) on ``n`` random rows against the plain version; -> (max
    |err|, cases)."""
    dev = torch.device("cuda")
    segments = sorted(segments or {1, 16, NG_A, 64, seg.max_segments(dev)})
    max_err, checked = 0.0, 0
    t0 = time.perf_counter()
    for S in segments:
        for dtype in SEG_DTYPES:
            x, gid = seg_inputs(n, S, dtype, gen, dev)
            for op in ("sum", "min", "max"):
                max_err = max(max_err, seg_check(seg, x, gid, S, op))
                checked += 1
            del x, gid
    log(f"[segments] n={n}: every dtype and op at S in {segments} match the plain version "
        f"({time.perf_counter() - t0:.1f} s)")
    return max_err, checked


def segment_phase(rows: int, seed: int, before=None) -> dict:
    """The segment kernel against its plain version (``segment_cases`` at
    ``rows``, 65,536, 1,048,576 and 16,777,216 rows), then timed at query (a)'s shape: SUM of a float64 column over 17 slots,
    dead rows routed past the last (two of (a)'s eight launches), beside
    the other (a) cases, the plain version and ``index_add_``."""
    from baikaldb_tpu_torch.ops import segments as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    max_err, checked = 0.0, 0
    # 65,536 rows (a streamed chunk), a mesh shard's 1,048,576 (TPC-H
    # lineitem) and 16,777,216 (phase 10's (a)) at every slot count, and the
    # whole table at (a)'s 17 slots, the only count the 100M-row path gives
    # the kernel (every count there until PR 17); phase 11 adds an odd length
    # (versioned_kernel_checks)
    for n, segments in ((1 << 16, None), (1 << 20, None), (1 << 24, None), (rows, {NG_A})):
        err, k = segment_cases(seg, n, gen, segments)
        max_err, checked = max(max_err, err), checked + k
    gate = seg.max_segments(dev)
    # the wrap of int64 sums, exactly
    x = torch.tensor([2**62, 2**62, 2**62, -5], dtype=torch.int64, device=dev)
    got = seg.segment_reduce(x, torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=dev),
                             3, "sum").tolist()
    if got != [-(2**62), -5, 0]:
        raise AssertionError(f"int64 sums do not wrap: {got}")

    # times at query (a)'s shape
    codes = torch.randint(0, NG_A - 1, (rows,), generator=gen, device=dev, dtype=torch.int32)
    mask = torch.rand(rows, generator=gen, device=dev) < 0.6
    v = torch.randn(rows, generator=gen, device=dev)
    w = v.double()
    gid = torch.where(mask, codes, NG_A)
    live = int(mask.sum())
    ids = gid.long()
    acc = torch.zeros(NG_A + 1, dtype=torch.float64, device=dev)
    nbytes = rows * (4 + 8) + NG_A * 8
    ops = live                                  # one float64 add a live row
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F64_OPS_PER_S * 1e3
    bseg = None if before is None else compared_segments(before)
    dev_ms, turns = in_turns(lambda: seg.segment_reduce(w, gid, NG_A, "sum"),
                             None if bseg is None else
                             lambda: bseg.segment_reduce(w, gid, NG_A, "sum"), device_ms)
    out = {
        "ms": cuda_ms(lambda: seg.segment_reduce(w, gid, NG_A, "sum"), 20),
        "device_ms": dev_ms,
        "plain_ms": cuda_ms(lambda: seg.segment_reduce_plain(w, gid, NG_A, "sum"), 3),
        "library_ms": cuda_ms(lambda: acc.index_add_(0, ids, w), 3),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": max_err, "checked_cases": checked, "segments": NG_A,
        "gate": gate, "by_case": {}}
    if turns is not None:
        out["before"] = turns
    for name, x, op in (("count_i32", mask.to(torch.int32), "sum"),
                        ("count_i64", mask.to(torch.int64), "sum"),
                        ("min_f32", v, "min")):
        b = (rows * (4 + x.element_size()) + NG_A * 8) / HBM_BYTES_PER_S * 1e3
        out["by_case"][name] = {
            "device_ms": device_ms(lambda: seg.segment_reduce(x, gid, NG_A, op)),
            "bound_ms": b}
    c_gid, c_w = gid[:1 << 16].clone(), w[:1 << 16].clone()
    out["chunk"] = {"rows": 1 << 16,
                    "ms": cuda_ms(lambda: seg.segment_reduce(c_w, c_gid, NG_A, "sum"), 20),
                    "device_ms": device_ms(lambda: seg.segment_reduce(c_w, c_gid, NG_A, "sum"))}
    log(f"[segments] segment_reduce: {out['ms']:.4f} ms a call, {out['device_ms']:.4f} ms on "
        f"the device (plain {out['plain_ms']:.3f} ms, index_add_ {out['library_ms']:.3f} ms, "
        f"bound {out['bound_ms']:.4f} ms) at n={rows} S={NG_A}; {out['by_case']}")
    return out


def wide_phase(seed: int) -> dict:
    """The wide dense GROUP BY kernel (``hashagg.dense_group_agg``) against
    ``dense_group_agg_plain`` on the card at ``bench/dense_wide.py``'s q10
    and q18-inner shapes: ``present``, counts, integers and MIN/MAX exact,
    float64 sums to 1e-12 relative, one launch a call; then each timed
    beside the plain version, the library passes it replaces and its
    bound."""
    from baikaldb_tpu_torch.bench import dense_wide as dw
    from baikaldb_tpu_torch.ops import dense_agg, hashagg

    out = {}
    for name in ("q10", "q18_inner"):
        gid, sel, cols, specs, ng = dw.shape(name, "cuda", seed)

        def kernel():
            return hashagg.dense_group_agg(gid, sel, cols, specs, ng)

        def plain():
            return hashagg.dense_group_agg_plain(gid, sel, cols, specs, ng)

        before = dense_agg.LAUNCHES[WIDE].value
        got = kernel()
        if dense_agg.LAUNCHES[WIDE].value - before != 1:
            raise AssertionError(f"[wide] {name}: "
                                 f"{dense_agg.LAUNCHES[WIDE].value - before} launches a call")
        rel = dw.compare(got, plain(), specs)
        del got
        out[name] = {"rows": gid.shape[0], "slots": ng,
                     "live": gid.shape[0] if sel is None else int(sel.sum()),
                     "aggregates": [f"{s.op}({s.input})" for s in specs],
                     "sum_rel_err": rel,
                     "ms": cuda_ms(kernel, 20), "device_ms": device_ms(kernel),
                     "plain_ms": cuda_ms(plain, 3),
                     "library_ms": cuda_ms(dw.library_chain(gid, sel, cols, specs, ng), 3),
                     "bound_ms": dw.bound_ms(gid, sel, cols, specs, ng)}
        log(f"[wide] {name}: matches the plain version (sums within {rel:.2e}); "
            f"{out[name]['ms']:.4f} ms a call, {out[name]['device_ms']:.4f} ms on the device "
            f"(plain {out[name]['plain_ms']:.3f} ms, library {out[name]['library_ms']:.3f} ms, "
            f"bound {out[name]['bound_ms']:.4f} ms)")
        del gid, sel, cols
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 3: SQL at real size


def reference(keys, vals, mask, ng):
    """numpy float64 group-by: counts, sums, sum|v|, mins (f32 values)."""
    k = keys[mask]
    v = vals[mask]
    counts = np.bincount(k, minlength=ng)
    sums = np.bincount(k, weights=v.astype(np.float64), minlength=ng)
    sabs = np.bincount(k, weights=np.abs(v).astype(np.float64), minlength=ng)
    mins = np.full(ng, np.inf)
    np.minimum.at(mins, k, v.astype(np.float64))
    return counts, sums, sabs, mins


def check_rows(name, rows, ref, has_count=True, has_min=True):
    """Against the numpy reference: group keys and counts exact, each SUM
    within 1e-5 * sum(|v|) over its group, AVG within that over the count,
    MIN exact."""
    counts, sums, sabs, mins = ref
    keys = [int(i) for i in np.nonzero(counts)[0]]
    cols = list(rows[0]) if rows else []
    if [r[cols[0]] for r in rows] != keys:
        raise AssertionError(f"query ({name}): group keys differ from numpy")
    for r in rows:
        g, *vals = (r[c] for c in cols)
        if has_count:
            if vals[0] != counts[g]:
                raise AssertionError(f"query ({name}) group {g}: count {vals[0]} != {counts[g]}")
            vals = vals[1:]
        sm, avg = vals[0], vals[1]
        tol = 1e-5 * sabs[g] + 1e-12
        if abs(sm - sums[g]) > tol or abs(avg - sums[g] / counts[g]) > tol / counts[g]:
            raise AssertionError(f"query ({name}) group {g}: sum/avg {sm}/{avg} vs "
                                 f"{sums[g]}/{sums[g] / counts[g]}")
        if has_min and vals[2] != mins[g]:
            raise AssertionError(f"query ({name}) group {g}: min {vals[2]} != {mins[g]}")


def device_breakdown(run, wall_ms: float, host_ops: bool = True,
                     tries: int = PROFILE_TRIES) -> dict:
    """One profiled run: device time summed over CUDA kernels and copies,
    the idle share of the unprofiled wall time, the top kernels, and K2's
    kernels' device time (``k2_device_ms``: ``agg_lanes_kernel``,
    ``agg_kernel`` and ``agg_merge``).  ``host_ops=False`` traces the device
    alone (a streamed run launches too many host operators to trace them all
    cheaply)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from baikaldb_tpu_torch.ops import group_kernels as gk

    def launched() -> int:
        return sum(all_launches(gk).values()) + sum(lane_launches(gk).values())

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    for _ in range(tries):
        torch.cuda.synchronize()
        n0 = launched()
        with profile(activities=acts) as prof:
            time.sleep(PROFILE_PAD_S)
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        launches = launched() - n0
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev = [(e.key, e.self_device_time_total / 1e3) for e in events]
        # each wrapper call launches one main kernel: a trace holding fewer
        # lost device records, and its sums would understate the device time
        recorded = sum(e.count for e in events if OWN_KERNEL.search(e.key))
        if recorded >= launches and (dev or not launches):
            break
    else:
        log(f"[profile] {tries} profiled run(s) recorded {recorded} of the run's "
            f"{launches} kernel launches: device time not measured")
        return {"device_ms": None, "idle_share": None, "top_kernels": [],
                "k2_device_ms": None, "device_ops": None, "kernel_names": [],
                "device_not_measured": f"the profiler recorded {recorded} of {launches} "
                                       f"kernel launches in {tries} run(s)"}
    busy = sum(ms for _, ms in dev)
    top = sorted(dev, key=lambda kv: -kv[1])[:4]
    return {"device_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "top_kernels": [[k[:60], ms] for k, ms in top],
            "k2_device_ms": sum(ms for k, ms in dev if K2_KERNEL.search(k)),
            "device_ops": sum(e.count for e in events),
            "kernel_names": sorted(k for k, _ in dev)}


def fmt(x, spec: str) -> str:
    """``x`` formatted, or "not measured" where a profiled run lost it."""
    return "not measured" if x is None else format(x, spec)


def sql_table(rows: int, seed: int):
    """The table of phases 3 and 5 (Arrow) and the numpy float64 references
    of queries (a)-(c)."""
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    g = rng.integers(0, 2048, rows, dtype=np.int32)
    v = rng.standard_normal(rows, dtype=np.float32)
    w = rng.standard_normal(rows)
    g16 = rng.integers(0, 16, rows, dtype=np.int32)
    keep_v = (v * np.float32(2) + np.float32(1)).astype(np.float64) > 0.5
    keep_w = w > -1
    refs = {"a": reference(g16, v, keep_v, 16), "b": reference(g, v, keep_v, 2048),
            "c": reference(g, w, keep_w, 2048)}
    return pa.table({"g": g, "v": v, "w": w, "g16": g16}), refs


def check_query(q: str, rows, refs) -> None:
    if q == "c":
        check_rows("c", rows, refs["c"], has_count=False, has_min=False)
    else:
        check_rows(q, rows, refs[q])


def sql_phase(gk, table, refs) -> tuple[dict, dict, object]:
    """-> (launches, measurements, the session: phase 10 (i) shards its
    table)."""
    from baikaldb_tpu_torch.exec.session import Session

    rows = table.num_rows
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = Session(device="cuda")
    # the resident path, as in the runs before streamed scans existed
    s.execute("SET GLOBAL streaming_scan = 0")
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", table)
    s.db.stores["default.t"].device_table_batch()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[sql] {rows} rows loaded and staged on the card in {load_s:.2f} s")
    try:
        return (*_sql_runs(gk, s, rows, refs, load_s), s)
    finally:
        s.execute("SET GLOBAL streaming_scan = 1")


def _sql_runs(gk, s, rows: int, refs, load_s: float) -> tuple[dict, dict]:

    # the main path: counters at 0 just before, read just after
    reset_launches(gk)
    results, per_query = {}, {}
    for q, sql in QUERIES.items():
        before = all_launches(gk)
        results[q] = s.query(sql)
        torch.cuda.synchronize()
        per_query[q] = {k: v - before[k] for k, v in all_launches(gk).items()
                        if v != before[k]}
    launches = all_launches(gk)
    for q, want in EXPECTED_LAUNCHES.items():
        if per_query[q] != want:
            raise AssertionError(f"query ({q}) launched {per_query[q]}, expected {want}")

    for q in QUERIES:
        check_query(q, results[q], refs)
    log(f"[sql] results match numpy; launches {per_query}")

    # warm wall times: median and the highest percentile with ten samples
    # beyond it (the 20th of 30)
    sql_stats = {"load_s": load_s}
    for q, sql in QUERIES.items():
        walls = []
        for _ in range(WARM_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        walls.sort()
        med = statistics.median(walls)
        sql_stats[q] = {"warm_ms_p50": med, "warm_ms_p67": walls[WARM_REPS - 11],
                        "rows_per_s": rows / (med / 1e3), "launches": per_query[q],
                        **device_breakdown(lambda: s.query(sql), med)}
        scatters = [k for k in sql_stats[q].pop("kernel_names") if "indexFunc" in k]
        sql_stats[q]["index_add_kernels"] = len(scatters)
        if q == "a" and scatters:
            raise AssertionError(f"query (a) ran index_add_ on the card: {scatters}")
        log(f"[sql] ({q}) warm wall p50 {med:.2f} ms p67 {walls[WARM_REPS - 11]:.2f} ms "
            f"over {WARM_REPS} runs, device busy {fmt(sql_stats[q]['device_ms'], '.2f')} ms: {sql}")
    sql_stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return launches, sql_stats


# ----------------------------------------------------------------------
# phase 4: streamed scans over the same table

STREAM_EXPECTED = {"b": {"partition_histogram": 1, "fused_group_aggregate": 1},
                   "c": {"filtered_group_sum": 1, "partition_histogram": 1}}


@contextlib.contextmanager
def flag(s, name: str, value):
    """``SET GLOBAL name = value`` for the block, then back."""
    from baikaldb_tpu_torch.utils.flags import FLAGS

    prev = getattr(FLAGS, name)
    s.execute(f"SET GLOBAL {name} = {value}")
    try:
        yield
    finally:
        s.execute(f"SET GLOBAL {name} = {int(prev) if isinstance(prev, bool) else prev}")


def traced_run(s, sql: str) -> tuple[list, dict, dict]:
    """One traced run: -> (rows, span milliseconds by name, the ``stream``
    event's attributes or {})."""
    from baikaldb_tpu_torch.obs import trace

    with flag(s, "tracing", 1):
        rows = s.query(sql)
        torch.cuda.synchronize()
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    spans: dict = {}
    event: dict = {}
    for sp in rec["spans"]:
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + sp["dur_ms"]
        if sp["name"] == "stream":
            event = dict(sp["attrs"])
    return rows, spans, event


def stream_counts(gk) -> dict:
    from baikaldb_tpu_torch.utils import metrics

    return {"launches": launch_counts(gk), "chunks": metrics.stream_chunks.value,
            "skipped": metrics.stream_chunks_skipped.value,
            "stage_swallowed": metrics.REGISTRY.counter(
                "swallowed.session.stream_stage").value}


def streamed_query(gk, s, q: str, refs, n_chunks: int, reps: int,
                   profile: bool = True) -> dict:
    """Query ``q`` streamed: the first run traced (its ``stream`` event),
    the numpy check, the launches and chunks of that run against what one
    pass over ``n_chunks`` chunks must give, ``reps`` warm runs, one
    profiled run of the device (with ``profile``), the peak device memory
    over them."""
    sql = QUERIES[q]
    torch.cuda.reset_peak_memory_stats()
    before = stream_counts(gk)
    t = time.perf_counter()
    rows, spans, event = traced_run(s, sql)
    first_ms = (time.perf_counter() - t) * 1e3
    after = stream_counts(gk)
    check_query(q, rows, refs)
    launched = {k: v - before["launches"][k] for k, v in after["launches"].items()
                if v != before["launches"][k]}
    chunks = after["chunks"] - before["chunks"]
    if chunks != n_chunks or after["skipped"] != before["skipped"]:
        raise AssertionError(f"streamed ({q}) folded {chunks} chunks, expected {n_chunks}")
    want = {k: n * n_chunks for k, n in STREAM_EXPECTED[q].items()}
    if launched != want:
        raise AssertionError(f"streamed ({q}) launched {launched}, expected {want}")
    if after["stage_swallowed"] != 0:
        raise AssertionError("a chunk-set build failed and the query ran resident")
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.query(sql)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(walls)
    # one profiled run: a streamed run's trace loses a few of its thousands
    # of kernel records, and profiling it again (up to 3 tries before) ended
    # "not measured" all the same; at 65,536-row chunks (3,052 kernel
    # records) every profiled run lost 2-3, so those are not profiled
    prof = device_breakdown(lambda: s.query(sql), med, host_ops=False, tries=1) if profile \
        else {"device_ms": None, "idle_share": None, "top_kernels": [], "k2_device_ms": None,
              "device_ops": None, "kernel_names": [],
              "device_not_measured": "not profiled: its trace loses kernel records"}
    out = {"chunks": n_chunks, "first_ms": first_ms, "warm_ms": walls, "warm_ms_p50": med,
           "rows_per_s": s.db.stores["default.t"].num_rows / (med / 1e3),
           "kernel_launches": launched, "stream_event": event, "spans_ms": spans, **prof}
    out.pop("kernel_names")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[stream] ({q}) {n_chunks} chunks: first run {first_ms:.1f} ms, warm p50 {med:.1f} ms "
        f"over {reps} runs, device {fmt(out['device_ms'], '.1f')} ms, idle "
        f"{fmt(out['idle_share'], '.3f')}, "
        f"peak {out['peak_mem_gib']:.3f} GiB, launches {launched}, stream event {event}")
    return out


def streamed_phase(gk, table, refs, observe: dict | None = None) -> tuple[dict, dict]:
    """Phase 4: (b) and (c) streamed over a fresh Database (so the resident
    image of phase 3 is not counted), then (b) at 1M-row chunks.  -> (K1-K3
    launches of the phase's runs, measurements).  With ``observe``, phase 15
    (ii) follows in the same session and leaves its launches and
    measurements there."""
    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.utils.flags import FLAGS

    torch.cuda.empty_cache()
    s = Session(Database(device="cuda"))
    s.execute("CREATE TABLE t (g INT, v FLOAT, w DOUBLE, g16 INT)")
    s.load_arrow("t", table)
    rows = table.num_rows
    if not FLAGS.streaming_scan or rows < FLAGS.streaming_min_rows:
        raise AssertionError("the streamed phase needs streaming_scan on and "
                             f"at least {FLAGS.streaming_min_rows} rows")
    chunk = int(FLAGS.streaming_chunk_rows)
    # the streamed path: counters at 0 just before, read just after
    for c in gk.LAUNCHES.values():
        c.reset()
    out = {"chunk_rows": chunk}
    for q in ("b", "c"):
        out[q] = streamed_query(gk, s, q, refs, -(-rows // chunk), STREAM_REPS,
                                profile=False)
    with flag(s, "streaming_chunk_rows", BIG_CHUNK_ROWS):
        out["b_1m"] = streamed_query(gk, s, "b", refs, -(-rows // BIG_CHUNK_ROWS),
                                     STREAM_REPS)
    out["b_1m"]["chunk_rows"] = BIG_CHUNK_ROWS
    # the launches of the checked (first) runs
    launches = {k: sum(out[q]["kernel_launches"].get(k, 0) for q in ("b", "c", "b_1m"))
                for k in gk.LAUNCHES}
    if observe is not None:
        observe["ii_launches"], observe["ii"] = kill_streamed_part(gk, s, refs)
    return launches, out


# ----------------------------------------------------------------------
# phase 5: TPC-H


def load_tpch(session, tables: dict):
    from baikaldb_tpu_torch.models import tpch

    for name, ddl in tpch.DDL.items():
        session.execute(ddl)
        session.load_arrow(name, tables[name])
    return session


def launch_counts(gk) -> dict:
    return {k: c.value for k, c in gk.LAUNCHES.items()}


def tpch_card_vs_cpu(gk) -> tuple:
    """(i): all 22 queries on the card and on the CPU, equal by the parity
    contract (rtol 1e-4 where a float32 group-by kernel ran on the card); ->
    (the two sessions, for the analytic phase; the queries that streamed;
    the wide kernel's launches, which must be above 0)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch

    from baikaldb_tpu_torch.utils import metrics

    tables = tpch.generate(scale=TPCH_CHECK_SCALE, seed=0)
    gpu = load_tpch(Session(device="cuda"), tables)
    cpu = load_tpch(Session(device="cpu"), tables)
    streamed, wide = [], 0
    for q, sql in {**tpch.QUERIES, **tpch.VARIANTS}.items():
        wide -= all_launches(gk)[WIDE]
        before = launch_counts(gk)
        c0 = metrics.stream_chunks.value
        got = gpu.query(sql)
        if metrics.stream_chunks.value != c0:
            streamed.append(q)
        ran = launch_counts(gk) != before
        wide += all_launches(gk)[WIDE]
        diff = mismatch(got, cpu.query(sql), sql, 1e-4 if ran else 1e-9)
        if diff is not None:
            raise AssertionError(f"TPC-H {q} at SF {TPCH_CHECK_SCALE}: the card differs "
                                 f"from the CPU: {diff}")
        if q in tpch.VARIANTS and not got:
            raise AssertionError(f"TPC-H {q} at SF {TPCH_CHECK_SCALE}: no rows")
    if not wide:
        raise AssertionError(f"TPC-H at SF {TPCH_CHECK_SCALE}: the wide kernel never launched")
    log(f"[tpch] SF {TPCH_CHECK_SCALE}: all {len(tpch.QUERIES)} queries and "
        f"{len(tpch.VARIANTS)} variant equal on the card and the CPU; streamed: {streamed}; "
        f"wide kernel launches {wide}")
    return gpu, cpu, streamed, wide


def _arrow_np(table, col):
    return table.column(col).combine_chunks().to_numpy(zero_copy_only=False)


def check_q1_q6(rows_q1: list, rows_q6: list, lineitem) -> None:
    """q1 and q6 against numpy in float64: keys and counts exact, sums and
    averages to rtol 1e-9."""
    import datetime

    import pyarrow.compute as pc

    def days(iso):
        return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days

    ship = _arrow_np(lineitem, "l_shipdate").astype("datetime64[D]").astype(np.int64)
    qty, price = _arrow_np(lineitem, "l_quantity"), _arrow_np(lineitem, "l_extendedprice")
    disc, tax = _arrow_np(lineitem, "l_discount"), _arrow_np(lineitem, "l_tax")

    def close(a, b):
        return abs(a - b) <= 1e-9 * abs(b) + 1e-9

    keep = ship <= days("1998-09-02")
    rf = pc.dictionary_encode(lineitem.column("l_returnflag").combine_chunks())
    ls = pc.dictionary_encode(lineitem.column("l_linestatus").combine_chunks())
    rf_code, ls_code = rf.indices.to_numpy(), ls.indices.to_numpy()
    n_ls = len(ls.dictionary)
    gid = (rf_code * n_ls + ls_code)[keep]
    ng = len(rf.dictionary) * n_ls

    def gsum(x):
        return np.bincount(gid, weights=x[keep], minlength=ng)

    cnt = np.bincount(gid, minlength=ng)
    sums = {"sum_qty": gsum(qty), "sum_base_price": gsum(price),
            "sum_disc_price": gsum(price * (1 - disc)),
            "sum_charge": gsum(price * (1 - disc) * (1 + tax))}
    avgs = {"avg_qty": sums["sum_qty"] / np.maximum(cnt, 1),
            "avg_price": sums["sum_base_price"] / np.maximum(cnt, 1),
            "avg_disc": gsum(disc) / np.maximum(cnt, 1)}
    want = []
    for g in np.nonzero(cnt)[0]:
        r, l_ = divmod(int(g), n_ls)
        want.append((rf.dictionary[r].as_py(), ls.dictionary[l_].as_py(), int(g)))
    want.sort()
    if [(r["l_returnflag"], r["l_linestatus"]) for r in rows_q1] != [w[:2] for w in want]:
        raise AssertionError("TPC-H q1: group keys differ from numpy")
    for r, (_, _, g) in zip(rows_q1, want):
        if r["count_order"] != cnt[g]:
            raise AssertionError(f"TPC-H q1 {r['l_returnflag']}{r['l_linestatus']}: count "
                                 f"{r['count_order']} != {cnt[g]}")
        for k, v in list(sums.items()) + list(avgs.items()):
            if not close(r[k], float(v[g])):
                raise AssertionError(f"TPC-H q1 {r['l_returnflag']}{r['l_linestatus']}: "
                                     f"{k} {r[k]} != numpy {float(v[g])}")
    keep6 = ((ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
             & (disc >= 0.05) & (disc <= 0.07) & (qty < 24))
    rev = float(np.sum(price[keep6] * disc[keep6]))
    if len(rows_q6) != 1 or not close(rows_q6[0]["revenue"], rev):
        raise AssertionError(f"TPC-H q6: {rows_q6} != numpy {rev}")


def finite_rows(q: str, rows: list) -> None:
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not np.isfinite(v):
                raise AssertionError(f"{q}: {k} = {v}")


def span_ms(s, sql: str) -> dict:
    """Milliseconds of each session span in one traced run: ``query`` is the
    whole ``execute`` (the rest of the wall is the rows' conversion to
    dicts); ``parse`` and ``plan.build`` are host work alone, while
    ``exec.run`` and ``egress.arrow`` also wait for the card where they read
    from it."""
    from baikaldb_tpu_torch.obs import trace

    s.execute("SET GLOBAL tracing = 1")
    try:
        s.query(sql)
        torch.cuda.synchronize()
    finally:
        s.execute("SET GLOBAL tracing = 0")
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    out: dict = {}
    for sp in rec["spans"]:
        out[sp["name"]] = out.get(sp["name"], 0.0) + sp["dur_ms"]
    return out


def tpch_on_the_card(gk, scale: float, seed: int) -> tuple:
    """(ii): the 22 queries at ``scale`` on the card, timed.  -> (stats, the
    session, the tables, each query's rows: phase 16 (i)'s references)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch

    t0 = time.perf_counter()
    tables = tpch.generate(scale=scale, seed=seed)
    gen_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = load_tpch(Session(device="cuda"), tables)
    for store in s.db.stores.values():
        store.device_table_batch()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[tpch] SF {scale}: generated in {gen_s:.2f} s, loaded and staged on the card "
        f"in {load_s:.2f} s ({tables['lineitem'].num_rows} lineitem rows)")

    # the TPC-H path: counters at 0 just before, read just after
    reset_launches(gk)
    per_query, first = time_queries(gk, s, tpch.QUERIES, "tpch")
    check_q1_q6(first["q1"], first["q6"], tables["lineitem"])
    wide = {q: v["kernel_launches"][WIDE] for q, v in per_query.items()
            if v["kernel_launches"][WIDE]}
    if not wide:
        raise AssertionError(f"TPC-H at SF {scale}: the wide kernel never launched")
    log(f"[tpch] SF {scale}: q1 and q6 match numpy; wide kernel launches {wide}")
    return {"scale": scale, "seed": seed, "gen_s": gen_s, "load_s": load_s,
            "peak_mem_gib": max([load_peak] + [v["peak_mem_gib"] for v in per_query.values()]),
            "wide_launches": sum(wide.values()), "queries": per_query}, s, tables, first


def time_queries(gk, s, queries: dict, tag: str) -> tuple[dict, dict]:
    """Each query on the card: one warm-up run (its rows are kept and must
    be finite), the wall time of ``TPCH_REPS`` warm runs (``STREAM_REPS``
    when the query streamed; median and 67th percentile), the device time,
    idle share and top kernels of one profiled run, the session spans of
    one traced run, and the peak device memory, K1-K3 launches and streamed
    chunks of the warm-up run.  -> (stats per query, rows per query)."""
    from baikaldb_tpu_torch.utils import metrics

    per_query, first = {}, {}
    for q, sql in queries.items():
        before = all_launches(gk)
        c0 = metrics.stream_chunks.value
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        first[q] = s.query(sql)         # the warm-up run (plans, collects statistics)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        chunks = metrics.stream_chunks.value - c0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launched = {k: v - before[k] for k, v in all_launches(gk).items()}
        finite_rows(q, first[q])
        walls = []
        # a streamed query takes seconds at SF1: fewer warm runs
        reps = STREAM_REPS if chunks else TPCH_REPS
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(walls)
        per_query[q] = {"rows": len(first[q]), "first_ms": first_ms, "warm_ms_p50": med,
                        "warm_ms_p67": float(np.percentile(walls, 67)),
                        "peak_mem_gib": peak_gib, "kernel_launches": launched,
                        "streamed_chunks": chunks, "warm_runs": reps,
                        **device_breakdown(lambda: s.query(sql), med, host_ops=not chunks),
                        "spans_ms": span_ms(s, sql)}
        per_query[q]["index_add_kernels"] = sum(
            "indexFunc" in k for k in per_query[q].pop("kernel_names"))
        log(f"[{tag}] {q}: {len(first[q])} rows, {chunks} chunks streamed, first run "
            f"{first_ms:.1f} ms, warm p50 "
            f"{med:.2f} ms p67 {per_query[q]['warm_ms_p67']:.2f} ms, device "
            f"{fmt(per_query[q]['device_ms'], '.2f')} ms, idle "
            f"{fmt(per_query[q]['idle_share'], '.3f')}, "
            f"peak {peak_gib:.3f} GiB, kernel launches {launched}, "
            f"top {per_query[q]['top_kernels']}, spans "
            + " ".join(f"{k} {v:.2f}" for k, v in per_query[q]["spans_ms"].items()))
    return per_query, first


def tpch_streamed_vs_resident(s, queries=("q1", "q6")) -> dict:
    """Phase 7: each query streamed and resident in turns,
    ``STREAM_TPCH_REPS`` runs each, in phase 5 (ii)'s session; the rows of
    the two paths equal by the parity contract."""
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.utils import metrics

    out = {}
    for q in queries:
        sql = tpch.QUERIES[q]
        walls = {"streamed": [], "resident": []}
        rows = {}
        for _ in range(STREAM_TPCH_REPS):
            for path, on in (("streamed", 1), ("resident", 0)):
                with flag(s, "streaming_scan", on):
                    c0 = metrics.stream_chunks.value
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rows[path] = s.query(sql)
                    torch.cuda.synchronize()
                    walls[path].append((time.perf_counter() - t) * 1e3)
                    if (metrics.stream_chunks.value > c0) != bool(on):
                        raise AssertionError(f"TPC-H {q}: the {path} run took the other path")
        diff = mismatch(rows["streamed"], rows["resident"], sql)
        if diff is not None:
            raise AssertionError(f"TPC-H {q}: streamed differs from resident: {diff}")
        out[q] = {path: {"walls_ms": w, "p50_ms": statistics.median(w)}
                  for path, w in walls.items()}
        log(f"[stream] TPC-H {q}: streamed p50 {out[q]['streamed']['p50_ms']:.2f} ms, "
            f"resident p50 {out[q]['resident']['p50_ms']:.2f} ms over {STREAM_TPCH_REPS} "
            "runs each, rows equal")
    return out


# ----------------------------------------------------------------------
# phase 6: analytics (windows, sketches, builtins)


def analytic_phase(gk, check: tuple, s, tables: dict, scale: float) -> dict:
    """(i) the analytic set on the card against the CPU on phase 5 (i)'s
    tables; (ii) timed in phase 5 (ii)'s session over its tables, with the
    K1-K3 launches over the run (counters at 0 just before, read just
    after), peak device memory, and the numpy checks."""
    from baikaldb_tpu_torch.models import analytics
    from baikaldb_tpu_torch.models.parity import mismatch

    gpu, cpu = check[:2]
    for q, sql in analytics.QUERIES.items():
        got = gpu.query(sql)
        diff = mismatch(got, cpu.query(sql), sql)
        if diff is not None:
            raise AssertionError(f"analytic {q} at SF {TPCH_CHECK_SCALE}: the card differs "
                                 f"from the CPU: {diff}")
        if not got:
            raise AssertionError(f"analytic {q} at SF {TPCH_CHECK_SCALE}: no rows")
    log(f"[analytics] SF {TPCH_CHECK_SCALE}: all {len(analytics.QUERIES)} queries equal on "
        "the card and the CPU")

    torch.cuda.empty_cache()
    reset_launches(gk)
    per_query, first = time_queries(gk, s, analytics.QUERIES, "analytics")
    launches = all_launches(gk)
    hll_err = analytics.check_against_numpy(first, tables["lineitem"])
    log(f"[analytics] SF {scale}: w_rank and the sketches match numpy (APPROX_COUNT_DISTINCT "
        f"relative errors {hll_err}); kernel launches {launches}")
    return {"scale": scale, "kernel_launches": launches, "hll_rel_err": hll_err,
            "peak_mem_gib": max(v["peak_mem_gib"] for v in per_query.values()),
            "queries": per_query,
            "results": {q: first[q] for q in ("w_rank", "a_sketch_all")}}


# ----------------------------------------------------------------------
# phase 8: egress functions and catalog statements, card against CPU

EGRESS_QUERIES = (
    "SELECT DATE_FORMAT(l_shipdate, '%Y-%m') m, COUNT(*) c, SUM(l_quantity) q FROM lineitem "
    "GROUP BY DATE_FORMAT(l_shipdate, '%Y-%m') ORDER BY m",
    "SELECT o_orderkey, FORMAT(o_totalprice, 2) p, HEX(o_orderkey) h, BIN(o_custkey) b, "
    "OCT(o_orderkey) o, DATE_FORMAT(o_orderdate, '%W %M %e %Y') d FROM orders "
    "WHERE DATE_FORMAT(o_orderdate, '%Y') = '1995' ORDER BY o_orderkey LIMIT 50",
    "SELECT c_custkey, HEX(c_nationkey) h, OCT(c_custkey) o FROM customer "
    "WHERE HEX(c_nationkey) = 'A' ORDER BY c_custkey DESC LIMIT 20",
)
CATALOG_STATEMENTS = (
    "CREATE DATABASE smoke_db", "USE smoke_db",
    "CREATE TABLE e (a INT, d DATE, x DOUBLE, PRIMARY KEY (a))",
    "INSERT INTO e VALUES (1, '2024-02-29', 1.5), (2, NULL, -2.25), (3, '1999-12-31', NULL)",
    "CREATE VIEW ev AS SELECT a, x * 2 y FROM e WHERE a > 1",
    "?SELECT * FROM ev ORDER BY a", "?SHOW TABLES", "?SHOW FULL TABLES", "?DESCRIBE ev",
    "?DESCRIBE e", "?SHOW CREATE TABLE e", "?SHOW CREATE TABLE ev", "?SHOW COLUMNS FROM e",
    "?SHOW FULL COLUMNS FROM e", "?SHOW INDEX FROM e", "?SHOW VARIABLES LIKE 'onehot%'",
    "?SHOW DATABASES", "TRUNCATE TABLE e", "?SELECT COUNT(*) n FROM e", "DROP VIEW ev",
    "DROP TABLE e", "?SHOW TABLES", "USE default", "DROP DATABASE smoke_db", "?SHOW DATABASES",
)


def egress_phase(check: tuple) -> dict:
    """The egress functions over phase 5 (i)'s tables and the catalog
    statements, each on the card and on the CPU session; the rows (``?``
    statements) and the INTO OUTFILE files must be equal."""
    import tempfile

    from baikaldb_tpu_torch.models.parity import mismatch

    gpu, cpu = check[:2]
    rows = 0
    for sql in EGRESS_QUERIES:
        got = gpu.query(sql)
        diff = mismatch(got, cpu.query(sql), sql)
        if diff is not None or not got:
            raise AssertionError(f"egress: the card differs from the CPU ({diff}) or no rows: "
                                 f"{sql}")
        rows += len(got)
    for stmt in CATALOG_STATEMENTS:
        if stmt.startswith("?"):
            got, want = gpu.query(stmt[1:]), cpu.query(stmt[1:])
            if got != want:
                raise AssertionError(f"catalog: {stmt[1:]}: card {got} != CPU {want}")
            rows += len(got)
        else:
            gpu.execute(stmt)
            cpu.execute(stmt)
    with tempfile.TemporaryDirectory() as tmp:
        texts = []
        for name, sess in (("card", gpu), ("cpu", cpu)):
            path = os.path.join(tmp, f"{name}.tsv")
            n = sess.execute(f"SELECT o_orderkey, o_totalprice, o_comment, HEX(o_custkey) h "
                             f"FROM orders WHERE o_orderkey < 2000 ORDER BY o_orderkey "
                             f"INTO OUTFILE '{path}'").affected_rows
            texts.append((n, open(path).read()))
        if texts[0] != texts[1] or not texts[0][0]:
            raise AssertionError("INTO OUTFILE: the card's file differs from the CPU's")
    log(f"[egress] {len(EGRESS_QUERIES)} egress queries, {len(CATALOG_STATEMENTS)} catalog "
        f"statements and INTO OUTFILE ({texts[0][0]} rows) equal on the card and the CPU")
    return {"egress_queries": len(EGRESS_QUERIES), "statements": len(CATALOG_STATEMENTS),
            "rows_checked": rows, "outfile_rows": texts[0][0]}


# ----------------------------------------------------------------------
# phase 9: vectors (VECTOR columns, the distance functions, the ANN index,
# ops/vector) at BASELINE config #4's size

VEC_ROWS = 1_000_000
VEC_DIM = 128
VEC_QUERIES = 32
VEC_K = 10
VEC_REPS = 10
VEC_SHORTLIST = 256              # numpy's candidates before the exact ranking
KMEANS_CLUSTERS = 1000
KMEANS_ITERS = 10
BF16_OPS_PER_S = 989e12          # H100 SXM, dense bf16 on the tensor cores
DOCS_QUERIES = (
    "SELECT id, L2_DISTANCE(emb, '[1,0,0,0]') d FROM docs ORDER BY d LIMIT 3",
    "SELECT id, L2_DISTANCE(emb, '[1,0,0,0]') d FROM docs "
    "WHERE L2_DISTANCE(emb, '[1,0,0,0]') IS NOT NULL ORDER BY d LIMIT 2",
    "SELECT id FROM docs WHERE tag = 'b' ORDER BY L2_DISTANCE(emb, '[1,0,0,0]') LIMIT 1",
    "SELECT id, COSINE_DISTANCE(emb, '[1,0.5,0,0]') c, INNER_PRODUCT(emb, '[1,0.5,0,0]') p, "
    "L2_DISTANCE(emb, '[1,0.5,0,0]') l FROM docs ORDER BY id",
    "SELECT id FROM docs ORDER BY INNER_PRODUCT(emb, '[1,0,0,0]') DESC LIMIT 1",
    "SELECT * FROM docs WHERE id = 1",
)
# phase 9 (ii): (name, ORDER BY, WHERE) over vt's emb; {q} is the vector
VEC_SHAPES = {
    "V-l2": ("L2_DISTANCE(emb, '{q}')", ""),
    "V-where": ("L2_DISTANCE(emb, '{q}')", "WHERE tag = 3 "),
    "V-cos": ("COSINE_DISTANCE(emb, '{q}')", ""),
    "V-ip": ("INNER_PRODUCT(emb, '{q}') DESC", ""),
    "V-ann": ("L2_DISTANCE(emb, '{q}')", ""),
}


def vec_lit(v) -> str:
    """A vector literal whose components parse back to ``v``'s float32
    values exactly."""
    return "[" + ",".join(repr(float(x)) for x in v) + "]"


def vec_sql(shape: str, q) -> str:
    order, where = VEC_SHAPES[shape]
    return f"SELECT id FROM vt {where}ORDER BY {order.format(q=vec_lit(q))} LIMIT {VEC_K}"


def exact_scores(rows: np.ndarray, q: np.ndarray, shape: str) -> np.ndarray:
    """The SQL distance of ``rows`` [m, d] (float32) to ``q`` computed as
    the planner's expansion computes it: component by component, left to
    right, differences and products in float64 (a FLOAT column against a
    DOUBLE literal), and COSINE_DISTANCE's row norm a FLOAT sum of FLOAT
    squares whose square root is DOUBLE.  Larger is nearer."""
    q64 = q.astype(np.float64)
    r64 = rows.astype(np.float64)
    if shape in ("V-l2", "V-where", "V-ann"):
        t = r64[:, 0] - q64[0]
        acc = t * t
        for i in range(1, len(q)):
            t = r64[:, i] - q64[i]
            acc = acc + t * t
        return -np.sqrt(acc)
    dot = r64[:, 0] * q64[0]
    for i in range(1, len(q)):
        dot = dot + r64[:, i] * q64[i]
    if shape == "V-ip":
        return dot
    sq = rows[:, 0] * rows[:, 0]
    for i in range(1, len(q)):
        sq = sq + rows[:, i] * rows[:, i]
    qn = float(sum(x * x for x in q64.tolist()) ** 0.5) or 1.0
    return -(1.0 - dot / (np.sqrt(sq.astype(np.float64)) * qn))


def numpy_topk(base: np.ndarray, tag: np.ndarray, queries: np.ndarray, shape: str,
               k: int = VEC_K) -> list:
    """numpy's top-k ids per query: a float32 product picks a shortlist,
    ``exact_scores`` ranks it, ties by id (the SQL sort is stable over the
    scan order)."""
    dots = queries @ base.T                                   # [q, n] float32
    if shape in ("V-l2", "V-where", "V-ann"):
        score = 2 * dots - (base * base).sum(1)[None, :]
    elif shape == "V-cos":
        score = dots / np.linalg.norm(base, axis=1)[None, :]
    else:
        score = dots
    if shape == "V-where":
        score[:, tag != 3] = -np.inf
    out = []
    for i, q in enumerate(queries):
        short = np.argpartition(score[i], -VEC_SHORTLIST)[-VEC_SHORTLIST:]
        if shape == "V-where":
            short = short[tag[short] == 3]
        ex = exact_scores(base[short], q, shape)
        order = np.lexsort((short, -ex))
        out.append([int(x) for x in short[order[:k]]])
    return out


def vector_card_vs_cpu() -> dict:
    """(i) the docs table (a NULL vector) and 8,000 clustered VECTOR(16)
    rows with an ANN INDEX (tests/test_ann_sql.py's data), inserted through
    INSERT into a card and a CPU session: every query's rows equal by the
    parity contract, the EXPLAIN lines equal and showing the ANN access,
    the ANN rows' recall@10 against numpy at least 0.95."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models.parity import mismatch

    rng = np.random.RandomState(11)
    centers = rng.randn(32, 16) * 4
    vecs = (centers[rng.randint(0, 32, 8000)] + rng.randn(8000, 16) * 0.5).astype(np.float32)
    qs = [vecs[i] + rng.randn(16).astype(np.float32) * 0.05 for i in rng.randint(0, 8000, 12)]
    sqls = list(DOCS_QUERIES)
    for q in qs:
        lit = vec_lit(q)
        sqls += [f"SELECT id FROM vt ORDER BY L2_DISTANCE(v, '{lit}') LIMIT 10",
                 f"SELECT id, tag FROM vt WHERE tag = 3 ORDER BY L2_DISTANCE(v, '{lit}') LIMIT 10",
                 f"SELECT id FROM vt ORDER BY COSINE_DISTANCE(v, '{lit}') LIMIT 10",
                 f"SELECT id FROM vt ORDER BY INNER_PRODUCT(v, '{lit}') DESC LIMIT 10",
                 f"SELECT id, L2_DISTANCE(v, '{lit}') d FROM vt ORDER BY d LIMIT 10"]
    explain = f"EXPLAIN SELECT id FROM vt ORDER BY L2_DISTANCE(v, '{vec_lit(qs[0])}') LIMIT 10"
    sessions = [Session(device="cuda"), Session(device="cpu")]
    # the flag registry is process-wide: one SET GLOBAL serves both sessions
    with flag(sessions[0], "ann_min_rows", 512):
        out = []
        for s in sessions:
            s.execute("CREATE TABLE docs (id BIGINT, tag VARCHAR, emb VECTOR(4))")
            s.execute("INSERT INTO docs VALUES (1, 'a', '[1,0,0,0]'), (2, 'b', '[0,1,0,0]'), "
                      "(3, 'a', '[0.9,0.1,0,0]'), (4, 'b', '[0,0,1,0]'), (5, 'a', NULL)")
            s.execute("CREATE TABLE vt (id BIGINT, tag INT, v VECTOR(16), ANN INDEX a (v))")
            for i in range(0, 8000, 400):
                s.execute("INSERT INTO vt VALUES " + ", ".join(
                    f"({j}, {j % 10}, '{vec_lit(vecs[j])}')" for j in range(i, i + 400)))
            out.append(([s.query(sql) for sql in sqls], s.execute(explain).plan_text))
    (got, gplan), (want, cplan) = out
    for sql, g, w in zip(sqls, got, want):
        diff = mismatch(g, w, sql)
        if diff is not None or not g:
            raise AssertionError(f"vectors: the card differs from the CPU ({diff}) or no rows: "
                                 f"{sql[:120]}")
    if gplan != cplan or "ann(a nprobe=8)" not in gplan:
        raise AssertionError(f"vectors: EXPLAIN on the card {gplan!r} vs the CPU {cplan!r}")
    hits = 0
    for qi, q in enumerate(qs):
        exact = set(np.argsort(((vecs - q) ** 2).sum(1))[:10].tolist())
        hits += len({r["id"] for r in got[len(DOCS_QUERIES) + 5 * qi]} & exact)
    recall = hits / (10 * len(qs))
    if recall < 0.95:
        raise AssertionError(f"vectors: ANN recall@10 {recall} < 0.95 on the clustered rows")
    log(f"[vectors] (i) {len(sqls)} queries equal on the card and the CPU, EXPLAIN "
        f"{[ln.strip() for ln in gplan.splitlines() if 'ann(' in ln][0][-40:]}, ANN recall@10 "
        f"{recall}")
    return {"queries": len(sqls), "ann_recall_at_10": recall}


def vector_sql(gk, seed: int) -> tuple[dict, dict, tuple]:
    """(ii) BASELINE config #4: ``vt (id BIGINT, tag INT, emb VECTOR(128))``
    at 1M rows from bench/ann.py's generator, each query shape for
    ``VEC_QUERIES`` vectors against numpy, then timed.  -> (launches of the
    path, measurements, (session, base, tag, queries))."""
    import pyarrow as pa

    from baikaldb_tpu_torch.bench.ann import make_data
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.utils import metrics

    t0 = time.perf_counter()
    base, queries, _ = make_data(VEC_ROWS, VEC_DIM, VEC_QUERIES, seed)
    tag = np.random.default_rng(seed).integers(0, 10, VEC_ROWS).astype(np.int32)
    table = pa.table({"id": np.arange(VEC_ROWS, dtype=np.int64), "tag": tag,
                      "emb": pa.FixedSizeListArray.from_arrays(pa.array(base.reshape(-1)),
                                                               VEC_DIM)})
    gen_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = Session(device="cuda")
    s.execute(f"CREATE TABLE vt (id BIGINT, tag INT, emb VECTOR({VEC_DIM}))")
    s.load_arrow("vt", table)
    ingest_s = time.perf_counter() - t0
    s.db.stores["default.vt"].device_table_batch()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    out = {"rows": VEC_ROWS, "dim": VEC_DIM, "queries": VEC_QUERIES, "gen_s": gen_s,
           "ingest_s": ingest_s, "load_s": load_s,
           "load_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"[vectors] (ii) {VEC_ROWS} x VECTOR({VEC_DIM}) generated in {gen_s:.2f} s, ingested "
        f"in {ingest_s:.2f} s, loaded and staged in {load_s:.2f} s")
    t0 = time.perf_counter()
    want = {shape: numpy_topk(base, tag, queries, shape) for shape in VEC_SHAPES
            if shape != "V-ann"}
    out["numpy_s"] = time.perf_counter() - t0

    # the vector path: counters at 0 just before, read just after
    reset_launches(gk)
    for shape in VEC_SHAPES:
        if shape == "V-ann":
            s.execute("ALTER TABLE vt ADD ANN INDEX a (emb)")
        before = all_launches(gk)
        scans0 = metrics.index_scans.value
        torch.cuda.reset_peak_memory_stats()
        firsts, got = [], []
        for i, q in enumerate(queries):
            sql = vec_sql(shape, q)
            t = time.perf_counter()
            if i == 0:
                rows, first_spans, _ = traced_run(s, sql)
            else:
                rows = s.query(sql)
                torch.cuda.synchronize()
            firsts.append((time.perf_counter() - t) * 1e3)
            got.append([r["id"] for r in rows])
        peak = torch.cuda.max_memory_allocated() / 2**30
        launched = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
        sql = vec_sql(shape, queries[0])
        if shape == "V-ann":
            exact = want["V-l2"]
            recall = float(np.mean([len(set(g) & set(e)) / VEC_K for g, e in zip(got, exact)]))
            if recall < 0.95:
                raise AssertionError(f"V-ann recall@10 {recall} < 0.95")
            plan = s.execute("EXPLAIN " + sql).plan_text
            if "ann(a nprobe=8)" not in plan or metrics.index_scans.value - scans0 != VEC_QUERIES:
                raise AssertionError(f"V-ann did not take the ANN path: {plan[-200:]}")
        else:
            bad = [i for i, (g, w) in enumerate(zip(got, want[shape])) if g != w]
            if bad:
                raise AssertionError(f"{shape} query {bad[0]}: {got[bad[0]]} != numpy "
                                     f"{want[shape][bad[0]]}")
        walls = []
        for _ in range(VEC_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        walls.sort()
        med = statistics.median(walls)
        st = {"first_query_ms": firsts[0], "first_query_spans_ms": first_spans,
              "other_vectors_ms_p50": statistics.median(firsts[1:]),
              "warm_ms_p50": med, "warm_ms_p67": float(np.percentile(walls, 67)),
              "peak_mem_gib": peak, "kernel_launches": launched,
              **device_breakdown(lambda: s.query(sql), med), "spans_ms": span_ms(s, sql)}
        st.pop("kernel_names")
        if shape == "V-ann":
            st["recall_at_10"] = recall
        out[shape] = st
        log(f"[vectors] {shape}: {VEC_QUERIES} vectors match numpy; first query "
            f"{firsts[0]:.1f} ms (spans {first_spans}), other vectors p50 "
            f"{st['other_vectors_ms_p50']:.2f} ms, warm p50 {med:.2f} ms p67 "
            f"{st['warm_ms_p67']:.2f} ms, device {fmt(st['device_ms'], '.2f')} ms, idle "
            f"{fmt(st['idle_share'], '.3f')}, peak {peak:.3f} GiB, launches {launched}, top "
            f"{st['top_kernels']}, spans {st['spans_ms']}")
    launches = all_launches(gk)
    # V-ann's training is the path's one k-means: one segment launch an
    # iteration (its counts); nothing on the path reaches K1-K3
    want_launches = {k: 0 for k in launches} | {"segment_reduce": KMEANS_ITERS}
    if launches != want_launches:
        raise AssertionError(f"vector path launches {launches} != {want_launches}")
    return launches, out, (s, base, tag, queries)


def vector_api(base: np.ndarray, queries: np.ndarray) -> dict:
    """(iii) ``brute_force_topk`` (bf16, f32), ``kmeans`` and ``ivf_topk``
    on the card at the same size: device ms against the bound, the top-10
    against numpy, k-means seconds."""
    from baikaldb_tpu_torch.ops import segments as seg
    from baikaldb_tpu_torch.ops import vector as tv

    dev = torch.device("cuda")
    bd, qd = torch.from_numpy(base).to(dev), torch.from_numpy(queries).to(dev)
    n, d = base.shape
    q = len(queries)
    bytes_ms = (base.nbytes + queries.nbytes) / HBM_BYTES_PER_S * 1e3
    flops = 2.0 * q * n * d
    exact = numpy_topk(base, None, queries, "V-l2")
    b2 = (base.astype(np.float64) ** 2).sum(1)
    out = {}
    for prec, peak in (("bf16", BF16_OPS_PER_S), ("f32", F32_OPS_PER_S)):
        def fn(prec=prec):
            return tv.brute_force_topk(qd, bd, None, VEC_K, "l2", prec)
        dms = device_ms(fn)
        prof = device_breakdown(fn, dms)
        scores, idx = (t.cpu().numpy() for t in fn())
        if scores.dtype != np.float32:
            raise AssertionError(f"brute_force_topk {prec}: scores are {scores.dtype}")
        for i in range(q):
            # the i-th row returned is as near as numpy's i-th, within the
            # score's error: f32, 1e-5 of the squared norms the L2 expansion
            # cancels; bf16, each product of rounded inputs is off by at
            # most ~2^-8 of |q_j b_j|, so 2 q.b by 2^-7 |q| |b|
            tol = (2.0 ** -7 * np.linalg.norm(queries[i]) * np.sqrt(b2.max()) if prec == "bf16"
                   else 1e-5 * (float(queries[i] @ queries[i]) + b2.max()))
            got_d2 = exact_scores(base[idx[i]], queries[i], "V-l2") ** 2
            want_d2 = exact_scores(base[exact[i]], queries[i], "V-l2") ** 2
            if idx[i][0] != exact[i][0] or (np.abs(got_d2 - want_d2) > tol).any():
                raise AssertionError(f"brute_force_topk {prec} query {i}: {idx[i]} vs numpy "
                                     f"{exact[i]}")
        out[f"brute_force_topk_{prec}"] = {
            "device_ms": dms, "top_kernels": prof["top_kernels"],
            "device_ops": prof["device_ops"], "bound_ms": max(bytes_ms, flops / peak * 1e3),
            "bound_by": "bytes" if bytes_ms >= flops / peak * 1e3 else "operations"}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = seg.LAUNCHES["segment_reduce"].value
    t0 = time.perf_counter()
    cent, assign = tv.kmeans(base, KMEANS_CLUSTERS, iters=KMEANS_ITERS, device=dev)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    km_launches = seg.LAUNCHES["segment_reduce"].value - before
    if km_launches != KMEANS_ITERS or not np.isfinite(cent).all():
        raise AssertionError(f"kmeans: {km_launches} segment launches, finite "
                             f"{np.isfinite(cent).all()}")
    out["kmeans"] = {"clusters": KMEANS_CLUSTERS, "iters": KMEANS_ITERS, "seconds": km_s,
                     "segment_launches": km_launches,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "empty_clusters": int(KMEANS_CLUSTERS - len(np.unique(assign)))}
    ct, at = torch.from_numpy(cent).to(dev), torch.from_numpy(assign).to(dev)
    # the segment kernel at k-means' shape (float64 ones, int64 ids from
    # argmax, 1000 segments) against its plain version, exactly; the
    # counts of the last iteration's assignment
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    cnt = seg.segment_reduce(ones, at, KMEANS_CLUSTERS, "sum")
    plain = seg.segment_reduce_plain(ones, at, KMEANS_CLUSTERS, "sum")
    if not torch.equal(cnt, plain) or not np.array_equal(
            cnt.cpu().numpy(), np.bincount(assign, minlength=KMEANS_CLUSTERS)):
        raise AssertionError(f"segment kernel at k-means' shape: max error "
                             f"{(cnt - plain).abs().max().item()} against the plain version")

    def ivf():
        return tv.ivf_topk(qd, bd, None, ct, at, VEC_K, 8, "l2", "f32")
    dms = device_ms(ivf)
    idx = ivf()[1].cpu().numpy()
    recall = float(np.mean([len(set(idx[i].tolist()) & set(exact[i])) / VEC_K
                            for i in range(q)]))
    if recall < 0.95:
        raise AssertionError(f"ivf_topk recall@10 {recall} < 0.95")
    out["ivf_topk_f32"] = {"device_ms": dms, "nprobe": 8, "recall_at_10": recall,
                           "bound_ms": max(bytes_ms, flops / F32_OPS_PER_S * 1e3)}
    log(f"[vectors] (iii) brute_force_topk bf16 "
        f"{out['brute_force_topk_bf16']['device_ms']:.3f} / f32 "
        f"{out['brute_force_topk_f32']['device_ms']:.3f} device-ms (bound {bytes_ms:.3f}), "
        f"kmeans {KMEANS_CLUSTERS} x {KMEANS_ITERS} in {km_s:.2f} s (its counts equal the "
        f"plain version's), ivf_topk {dms:.3f} "
        f"device-ms, recall@10 {recall}")
    return out


def vector_radius(s, base: np.ndarray, queries: np.ndarray) -> dict:
    """(iv) ``COUNT(*) ... WHERE L2_DISTANCE(emb, q) < r`` with the default
    flags, once: whether it streamed, its time, the count against numpy."""
    from baikaldb_tpu_torch.utils import metrics

    d = -exact_scores(base, queries[0], "V-l2")
    ds = np.sort(d)
    r = float((ds[999] + ds[1000]) / 2)
    want = int((d < r).sum())
    sql = (f"SELECT COUNT(*) n FROM vt WHERE L2_DISTANCE(emb, '{vec_lit(queries[0])}') "
           f"< {r!r}")
    c0 = metrics.stream_chunks.value
    torch.cuda.synchronize()
    t = time.perf_counter()
    rows, spans, event = traced_run(s, sql)
    ms = (time.perf_counter() - t) * 1e3
    chunks = metrics.stream_chunks.value - c0
    if rows != [{"n": want}]:
        raise AssertionError(f"radius count {rows} != numpy {want}")
    log(f"[vectors] (iv) radius count {want} in {ms:.1f} ms, streamed {chunks} chunks, "
        f"stream event {event}")
    return {"count": want, "ms": ms, "streamed_chunks": chunks, "stream_event": event,
            "spans_ms": spans}


def vector_phase(gk, seed: int) -> tuple[dict, dict]:
    """Phase 9: (i) card against CPU, (ii) BASELINE config #4 through SQL,
    (iii) the ops/vector API, (iv) a radius count.  -> (launches of (ii),
    measurements)."""
    out = {"card_vs_cpu": vector_card_vs_cpu()}
    torch.cuda.empty_cache()
    launches, out["sql"], (s, base, tag, queries) = vector_sql(gk, seed)
    out["api"] = vector_api(base, queries)
    out["radius"] = vector_radius(s, base, queries)
    return launches, out


# ----------------------------------------------------------------------
# phase 10: the mesh

MESH_REPS = 10
MESH_TPCH_REPS = 5
FLOAT_KERNELS = ("filtered_group_sum", "fused_group_aggregate")


def mesh_session(single):
    """A mesh session of ``MESH_SHARDS`` shards over ``single``'s database
    (its tables, staged once on the card), every table sharded before the
    clock of any query starts.  -> (session, seconds to shard)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    s = Session(db=single.db, mesh=make_mesh(MESH_SHARDS))
    for store in s.db.stores.values():
        store.sharded_batch(s.mesh)
    torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def mesh_sql_phase(gk, single, refs) -> tuple[dict, dict]:
    """Phase 10 (i): (a)-(c) over phase 3's table sharded 8 ways, checked
    against numpy; every shard's partial must launch (b)'s and (c)'s kernels
    once and (a)'s segment kernel 7 times, nothing else may launch one, and
    (a) may run no ``index_add_``.  -> (launches of the checked runs,
    measurements)."""
    from baikaldb_tpu_torch.parallel import agg as pagg

    torch.cuda.reset_peak_memory_stats()
    s, shard_s = mesh_session(single)
    # each shard's partial is one group_aggregate_dense call: its launches
    # are read around every call, so each shard's count is its own
    dense, shard_launches = pagg.group_aggregate_dense, []

    def counted(*args, **kw):
        before = all_launches(gk)
        out = dense(*args, **kw)
        shard_launches.append({k: v - before[k] for k, v in all_launches(gk).items()
                               if v != before[k]})
        return out

    # the mesh path: counters at 0 just before, read just after
    reset_launches(gk)
    results, per_query, per_shard = {}, {}, {}
    pagg.group_aggregate_dense = counted
    try:
        for q, sql in QUERIES.items():
            before = all_launches(gk)
            shard_launches.clear()
            results[q] = s.query(sql)
            torch.cuda.synchronize()
            per_query[q] = {k: v - before[k] for k, v in all_launches(gk).items()
                            if v != before[k]}
            per_shard[q] = list(shard_launches)
    finally:
        pagg.group_aggregate_dense = dense
    launches = all_launches(gk)
    for q, got in per_query.items():
        want = MESH_EXPECTED_LAUNCHES[q]
        total = {k: v * MESH_SHARDS for k, v in want.items()}
        if per_shard[q] != [want] * MESH_SHARDS or got != total:
            raise AssertionError(f"mesh query ({q}) launched {per_shard[q]} in its "
                                 f"{MESH_SHARDS} shards' partials and {got} in all, "
                                 f"expected {want} a shard and nothing else")
        check_query(q, results[q], refs)
    log(f"[mesh] (a)-(c) over {MESH_SHARDS} shards match numpy (sharded in {shard_s:.2f} s); "
        f"launches {per_query}")
    stats = {"shards": MESH_SHARDS, "shard_s": shard_s}
    for q, sql in QUERIES.items():
        walls = []
        for _ in range(MESH_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(walls)
        stats[q] = {"warm_ms_p50": med, "warm_ms_p67": float(np.percentile(walls, 67)),
                    "rows_per_s": single.db.stores["default.t"].num_rows / (med / 1e3),
                    "launches": per_query[q],
                    **device_breakdown(lambda: s.query(sql), med, host_ops=False)}
        scatters = [k for k in stats[q].pop("kernel_names") if "indexFunc" in k]
        stats[q]["index_add_kernels"] = len(scatters)
        if q == "a" and scatters:
            raise AssertionError(f"mesh query (a) ran index_add_ on the card: {scatters}")
        log(f"[mesh] ({q}) warm wall p50 {med:.2f} ms p67 {stats[q]['warm_ms_p67']:.2f} ms "
            f"over {MESH_REPS} runs, device {fmt(stats[q]['device_ms'], '.2f')} ms, idle "
            f"{fmt(stats[q]['idle_share'], '.3f')}, device ops {stats[q]['device_ops']}, "
            f"top {stats[q]['top_kernels']}")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return launches, stats


def mesh_tpch_phase(gk, single) -> tuple[dict, dict]:
    """Phase 10 (ii): the 22 TPC-H queries and ``q20_rows`` over phase 5
    (ii)'s tables sharded 8 ways, each equal to the single-device session's
    rows by the parity contract (rtol 1e-4 where a float group-by kernel ran
    on either side); q3 again with ``mpp_force_shuffle = 1``, which must
    execute at least one repartition round.  -> (launches of the checked
    runs, measurements)."""
    from baikaldb_tpu_torch.exec.executor import exchange_summary
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch
    from baikaldb_tpu_torch.sql.parser import parse_sql
    from baikaldb_tpu_torch.utils import metrics

    queries = {**tpch.QUERIES, **tpch.VARIANTS}
    want, single_floats = {}, {}
    for q, sql in queries.items():
        before = all_launches(gk)
        want[q] = single.query(sql)
        single_floats[q] = any(all_launches(gk)[k] != before[k] for k in FLOAT_KERNELS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s, shard_s = mesh_session(single)

    def checked(q, sql, tag):
        before = all_launches(gk)
        r0 = metrics.shuffle_rounds.value
        rows = s.query(sql)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
        floats = single_floats[q] or any(k in launched for k in FLOAT_KERNELS)
        diff = mismatch(rows, want[q], sql, 1e-4 if floats else 1e-9)
        if diff is not None:
            raise AssertionError(f"TPC-H {tag} on the mesh differs from one device: {diff}")
        finite_rows(q, rows)
        return launched, metrics.shuffle_rounds.value - r0

    # the mesh path: counters at 0 just before, read just after
    reset_launches(gk)
    checked_runs = {q: checked(q, sql, q) for q, sql in queries.items()}
    with flag(s, "mpp_force_shuffle", 1):
        summary = exchange_summary(s._plan_select(parse_sql(tpch.QUERIES["q3"])[0]))
        if summary["rounds"] < 1:
            raise AssertionError(f"q3 under mpp_force_shuffle planned no round: {summary}")
        checked_runs["q3_shuffle"] = checked("q3", tpch.QUERIES["q3"], "q3 (forced shuffle)")
    launches = all_launches(gk)
    log(f"[mesh] TPC-H: all {len(queries)} queries and q3 under forced shuffle "
        f"({summary}) equal on {MESH_SHARDS} shards and on one device (sharded in "
        f"{shard_s:.2f} s)")

    per_query = {}
    timed = {**queries, "q3_shuffle": tpch.QUERIES["q3"]}
    for q, sql in timed.items():
        with flag(s, "mpp_force_shuffle", int(q == "q3_shuffle")):
            walls = []
            for _ in range(MESH_TPCH_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                s.query(sql)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            med = statistics.median(walls)
            launched, rounds = checked_runs[q]
            per_query[q] = {"rows": len(want["q3" if q == "q3_shuffle" else q]),
                            "warm_ms_p50": med,
                            "warm_ms_p67": float(np.percentile(walls, 67)),
                            "kernel_launches": launched, "shuffle_rounds": rounds,
                            **device_breakdown(lambda: s.query(sql), med, host_ops=False)}
        per_query[q].pop("kernel_names")
        log(f"[mesh] {q}: warm p50 {med:.2f} ms p67 {per_query[q]['warm_ms_p67']:.2f} ms, "
            f"device {fmt(per_query[q]['device_ms'], '.2f')} ms, idle "
            f"{fmt(per_query[q]['idle_share'], '.3f')}, rounds {rounds}, launches {launched}, "
            f"top {per_query[q]['top_kernels']}")
    return launches, {"shards": MESH_SHARDS, "shard_s": shard_s, "queries": per_query,
                      "q3_shuffle_summary": summary,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


# ----------------------------------------------------------------------
# phase 11: the HTAP write path

SB_ROWS = 1_000_000              # BASELINE.json config #1
SB_TXNS = 100                    # 200 until PR 14; cut to keep the run within its limit
SB_PROFILED_TXNS = 5             # the last ones, under torch.profiler
SB_REGION_ROWS = 4096            # a cut: the default region holds all 1M rows
SB_LITERAL_TXNS = 1              # sysbench's own BETWEEN at the default region size (3 until PR 14)
HTAP_INSERT_ROWS = 10_000
HTAP_REPS = 10
DURABLE_ROWS = 100_000


def row_engine() -> str:
    """The native row engine must have built; -> its name, printed."""
    from baikaldb_tpu_torch import native
    from baikaldb_tpu_torch.storage import rowstore

    native.require()
    name = rowstore.engine_name()
    if name != "native":
        raise AssertionError(f"the row tier runs the {name} engine, not the native one")
    print(f"row engine: {name} ({native._so_path()})", flush=True)
    return name


def percentiles(ms: list) -> dict:
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def events_of(s, sql: str) -> tuple[list, dict, dict]:
    """One traced run: -> (rows, span milliseconds by name, event attributes
    by event name)."""
    from baikaldb_tpu_torch.obs import trace

    with flag(s, "tracing", 1):
        rows = s.query(sql)
        torch.cuda.synchronize()
    rec = [t for t in trace.TRACER.list() if t["text"] == sql][-1]
    spans, events = {}, {}
    for sp in rec["spans"]:
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + sp["dur_ms"]
        if sp.get("attrs"):
            events[sp["name"]] = dict(sp["attrs"])
    return rows, spans, events


def sysbench_phase(gk, seed: int) -> tuple[dict, dict]:
    """Phase 11 (i): sysbench oltp_read_write (models/sysbench.py) over the
    1M-row sbtest1, every SELECT against the replay reference; the final
    COUNT(*), SUM(k) and 1,000 sampled rows against it too; then config
    #1's analytical COUNT(*) under an automatic pin while a second session
    commits a write transaction, equal to the reference at the pin.
    -> (launches, measurements)."""
    from collections import defaultdict

    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import sysbench as sb

    torch.cuda.reset_peak_memory_stats()
    s = Session(device="cuda")
    s.execute(sb.DDL)
    s.db.stores["default.sbtest1"].region_rows = SB_REGION_ROWS
    t0 = time.perf_counter()
    table = sb.table(SB_ROWS, seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s.load_arrow("sbtest1", table)
    load_s = time.perf_counter() - t0
    del table
    # ranges as two comparisons, so that the region zone maps prune them
    drv = sb.Driver(s, SB_ROWS, seed, range_form="comparisons")
    times = defaultdict(list)

    def timer(kind, fn):
        t = time.perf_counter()
        out = fn()
        times[kind].append((time.perf_counter() - t) * 1e3)
        return out

    # the sysbench path: counters at 0 just before, read just after
    reset_launches(gk)
    t0 = time.perf_counter()
    drv.run(SB_TXNS - SB_PROFILED_TXNS, timer)
    wall = time.perf_counter() - t0
    # once: a second profiled run would commit more transactions
    dev = device_breakdown(lambda: drv.run(SB_PROFILED_TXNS),
                           wall / (SB_TXNS - SB_PROFILED_TXNS) * SB_PROFILED_TXNS * 1e3,
                           tries=1)
    launches = all_launches(gk)
    ref = drv.reference
    stats = {"rows": SB_ROWS, "transactions": SB_TXNS, "region_rows": SB_REGION_ROWS,
             "range_form": "comparisons",
             "gen_s": gen_s, "load_s": load_s, "wall_s": wall,
             "tx_per_s": (SB_TXNS - SB_PROFILED_TXNS) / wall,
             "statements": drv.statements,
             "per_kind": {k: percentiles(v) for k, v in times.items()},
             "profiled_transactions": SB_PROFILED_TXNS, "device_ms": dev["device_ms"],
             "idle_share": dev["idle_share"], "device_ops": dev["device_ops"],
             "top_kernels": dev["top_kernels"], "launches": launches}
    log(f"[sysbench] {SB_TXNS} transactions ({drv.statements} statements) match the replay; "
        f"{stats['tx_per_s']:.1f} tx/s, load {load_s:.2f} s, per kind "
        f"{ {k: round(v['p50_ms'], 2) for k, v in stats['per_kind'].items()} }")

    # config #1's analytical query under an automatic pin; a second session
    # commits right after the pin is taken, before the scan is staged
    lo, hi = SB_ROWS // 4, SB_ROWS // 2
    sql = f"SELECT COUNT(*) n FROM sbtest1 WHERE k BETWEEN {lo} AND {hi}"
    at_pin = int(((ref.k[1:] >= lo) & (ref.k[1:] <= hi)).sum())
    inside = np.nonzero((ref.k >= lo) & (ref.k <= hi))[0]
    outside = np.nonzero((ref.k < lo) | (ref.k > hi))[0]
    outside = outside[outside > 0]
    a, b, c = int(inside[0]), int(outside[0]), int(outside[1])
    writer = Session(s.db)
    reg = s.db.mvcc.snapshots
    pin = reg.pin
    pinned = []

    def pin_then_commit(ts, query="", holder=""):
        pid = pin(ts, query=query, holder=holder)
        pinned.append(ts)
        for q in ("BEGIN", f"UPDATE sbtest1 SET k = 1 WHERE id = {a}",
                  f"DELETE FROM sbtest1 WHERE id = {b}",
                  f"INSERT INTO sbtest1 VALUES ({b}, {lo}, 'x', 'y')",
                  f"UPDATE sbtest1 SET k = {hi} WHERE id = {c}", "COMMIT"):
            writer.execute(q)
        return pid

    reg.pin = pin_then_commit
    try:
        rows, spans, events = events_of(s, sql)
    finally:
        reg.pin = pin
    ref.k[a], ref.k[b], ref.k[c] = 1, lo, hi
    ref.c[b], ref.pad[b] = "x", "y"
    after = int(((ref.k[1:] >= lo) & (ref.k[1:] <= hi)).sum())
    snap = events.get("snapshot", {})
    if len(pinned) != 1 or rows != [{"n": at_pin}] or snap.get("versions_scanned", 0) <= 0:
        raise AssertionError(f"the pinned COUNT(*) read {rows} ({snap}), expected {at_pin} at "
                             "the pin over a versioned batch")
    if s.query(sql) != [{"n": after}] or after == at_pin:
        raise AssertionError(f"the unpinned COUNT(*) differs from the reference's {after}")
    total = s.query("SELECT COUNT(*) n, SUM(k) sk FROM sbtest1")
    if total != [{"n": SB_ROWS, "sk": int(ref.k.sum())}]:
        raise AssertionError(f"sysbench final COUNT(*), SUM(k) {total} differ from the replay")
    ids = np.sort(np.random.default_rng(seed).choice(np.arange(1, SB_ROWS + 1), 1000,
                                                     replace=False))
    got = s.query("SELECT id, k, c, pad FROM sbtest1 WHERE id IN ("
                  + ",".join(map(str, ids)) + ") ORDER BY id")
    want = [{"id": int(i), "k": int(ref.k[i]), "c": ref.c[i], "pad": ref.pad[i]} for i in ids]
    if got != want:
        raise AssertionError("sysbench sampled rows differ from the replay")
    stats["pinned_count"] = {"at_pin": at_pin, "after": after,
                             "versions_scanned": snap["versions_scanned"], "spans_ms": spans}
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[sysbench] pinned COUNT(*) {at_pin} at the pin over {snap['versions_scanned']} "
        f"history versions, {after} after the commit; final COUNT/SUM and 1,000 sampled rows "
        "match the replay")
    s.execute("DROP TABLE sbtest1")
    del s, writer, drv
    stats["literal"] = sysbench_literal(sb, seed)
    return launches, stats


def sysbench_literal(sb, seed: int) -> dict:
    """A few transactions of sysbench's own statements (``BETWEEN``
    ranges) at the default region size, where every range scans the whole
    table and the first after a commit re-stages it; checked against the
    replay.  -> per-kind times."""
    from collections import defaultdict

    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.storage.column_store import DEFAULT_REGION_ROWS

    s = Session(device="cuda")
    s.execute(sb.DDL)
    store = s.db.stores["default.sbtest1"]
    if store.region_rows != DEFAULT_REGION_ROWS:
        raise AssertionError(f"sbtest1 regions of {store.region_rows} rows")
    s.load_arrow("sbtest1", sb.table(SB_ROWS, seed))
    drv = sb.Driver(s, SB_ROWS, seed)
    times = defaultdict(list)

    def timer(kind, fn):
        t = time.perf_counter()
        out = fn()
        times[kind].append((time.perf_counter() - t) * 1e3)
        return out

    t0 = time.perf_counter()
    drv.run(SB_LITERAL_TXNS, timer)
    wall = time.perf_counter() - t0
    out = {"transactions": SB_LITERAL_TXNS, "region_rows": store.region_rows,
           "regions": len(store.regions), "range_form": "between", "wall_s": wall,
           "tx_per_s": SB_LITERAL_TXNS / wall,
           "per_kind_ms": {k: v for k, v in times.items()}}
    s.execute("DROP TABLE sbtest1")
    log(f"[sysbench] sysbench's BETWEEN at {store.region_rows}-row regions: "
        f"{SB_LITERAL_TXNS} transactions match the replay, {out['tx_per_s']:.2f} tx/s; "
        f"ranges (ms) { {k: [round(x, 1) for x in v] for k, v in times.items() if 'range' in k} }")
    return out


def htap_post_refs(table, seed: int):
    """Phase 11 (ii)'s writes as numpy: the inserted rows (Arrow) and the
    references of (a)-(c) over the rows after the transaction."""
    ins, cols, deleted, updated = htap_post_columns(table, seed)
    keep_v = (cols["v"] * np.float32(2) + np.float32(1)).astype(np.float64) > 0.5
    keep_w = cols["w"] > -1
    refs = {"a": reference(cols["g16"], cols["v"], keep_v, 16),
            "b": reference(cols["g"], cols["v"], keep_v, 2048),
            "c": reference(cols["g"], cols["w"], keep_w, 2048)}
    return ins, refs, deleted, updated


def htap_post_columns(table, seed: int):
    """-> (the inserted rows (Arrow), the columns after phase 11 (ii)'s
    transaction (numpy), rows deleted, rows updated)."""
    import pyarrow as pa

    rng = np.random.default_rng(seed + 11)
    ins = pa.table({"g": rng.integers(0, 2048, HTAP_INSERT_ROWS, dtype=np.int32),
                    "v": rng.standard_normal(HTAP_INSERT_ROWS, dtype=np.float32),
                    "w": rng.standard_normal(HTAP_INSERT_ROWS),
                    "g16": rng.integers(0, 16, HTAP_INSERT_ROWS, dtype=np.int32)})
    g = table.column("g").to_numpy()
    keep = g != 5
    cols = {c: table.column(c).to_numpy()[keep] for c in ("g", "v", "w", "g16")}
    upd = cols["g"] == 7
    cols["v"] = np.where(upd, cols["v"] + np.float32(1), cols["v"]).astype(np.float32)
    cols["w"] = np.where(upd, cols["w"] + 1.0, cols["w"])
    cols = {c: np.concatenate([cols[c], ins.column(c).to_numpy()]) for c in cols}
    return ins, cols, int((~keep).sum()), int(upd.sum())


def timed_query(s, sql: str, reps: int) -> dict:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.query(sql)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(walls)
    out = {"warm_ms_p50": med, "warm_ms_p67": float(np.percentile(walls, 67)),
           **device_breakdown(lambda: s.query(sql), med, host_ops=False)}
    out["index_add_kernels"] = len([k for k in out.pop("kernel_names") if "indexFunc" in k])
    return out


def versioned_kernel_checks(gk, store, snap_ts: int, seed: int) -> dict:
    """K1-K3 and the segment kernel against their plain versions on the
    pinned versioned batch itself: its length (the live rows plus the
    history, odd here), its columns and its ``sel`` (the visibility mask)
    ANDed with each query's WHERE, at the slots (a)-(c) give them; then
    every segment case of ``segment_cases`` at an odd length of ~1M rows
    (phase 1 ran them at 100M rows and below, all even)."""
    from baikaldb_tpu_torch.ops import segments as seg

    got = store.versioned_batch(snap_ts)
    if got is None:
        raise AssertionError("the pinned read has no versioned batch to check")
    vb, versions = got
    col = dict(zip(vb.names, vb.columns))
    g, g16, v, w = (col[c].data for c in ("g", "g16", "v", "w"))
    n = int(g.shape[0])
    where_v = vb.sel & ((v * 2 + 1).double() > 0.5)       # (a), (b)
    where_w = vb.sel & (w > -1)                            # (c)
    t0 = time.perf_counter()
    k_err = max(check_case(gk, g, v, where_v, NG_SQL),
                check_case(gk, g, w.float(), where_w, NG_SQL))
    gid = torch.where(where_v, g16, NG_A)
    s_err = 0.0
    for x, op in ((where_v.to(torch.int64), "sum"), (where_v.to(torch.int32), "sum"),
                  (v.double(), "sum"), (v, "sum"), (v, "min"), (v, "max")):
        s_err = max(s_err, seg_check(seg, x, gid, NG_A, op))
    del gid, where_v, where_w
    gen = torch.Generator(device=g.device)
    gen.manual_seed(seed + 13)
    err, cases = segment_cases(seg, ODD_SEG_ROWS, gen)
    out = {"rows": n, "history_versions": versions, "k_max_abs_err": k_err,
           "seg_max_abs_err": max(s_err, err), "seg_cases": cases + 6,
           "seg_case_rows": ODD_SEG_ROWS,
           "seconds": time.perf_counter() - t0}
    log(f"[htap] K1-K3 at {NG_SQL} slots and the segment kernel at {NG_A} on the versioned "
        f"batch ({n} rows, {versions} history versions) under (a)-(c)'s masks, and "
        f"{cases} segment cases at {ODD_SEG_ROWS} rows, match the plain versions")
    return out


def htap_snapshot_phase(gk, single, table, refs, seed: int) -> tuple[dict, dict]:
    """Phase 11 (ii), in phase 3's session over its 100M rows: session A pins
    (``SET SNAPSHOT = 'now'``); session B deletes ``g = 5``, updates ``v`` and
    ``w`` where ``g = 7`` and inserts 10,000 rows in one transaction and
    commits.  A's (a)-(c) equal phase 3's references over a versioned batch,
    B's the post-write numpy; each query launches exactly its kernels.
    -> (launches, measurements)."""
    from baikaldb_tpu_torch.exec.session import Session

    torch.cuda.reset_peak_memory_stats()
    a = single
    store = a.db.stores["default.t"]
    b = Session(a.db)
    ins, post, deleted, updated = htap_post_refs(table, seed)
    stats = {"deleted": deleted, "updated": updated, "inserted": HTAP_INSERT_ROWS}
    with flag(a, "streaming_scan", 0):
        a.execute("SET SNAPSHOT = 'now'")
        t0 = time.perf_counter()
        b.execute("BEGIN")
        n_del = b.execute("DELETE FROM t WHERE g = 5").affected_rows
        t1 = time.perf_counter()
        n_upd = b.execute("UPDATE t SET v = v + 1, w = w + 1 WHERE g = 7").affected_rows
        t2 = time.perf_counter()
        step = 1000
        for i in range(0, HTAP_INSERT_ROWS, step):
            part = ins.slice(i, step).to_pylist()
            b.execute("INSERT INTO t VALUES " + ",".join(
                f"({r['g']}, {r['v']!r}, {r['w']!r}, {r['g16']})" for r in part))
        t3 = time.perf_counter()
        b.execute("COMMIT")
        t4 = time.perf_counter()
        if (n_del, n_upd) != (deleted, updated):
            raise AssertionError(f"B deleted {n_del} and updated {n_upd} rows, expected "
                                 f"{deleted} and {updated}")
        stats.update(delete_s=t1 - t0, update_s=t2 - t1, insert_s=t3 - t2, commit_s=t4 - t3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.device_table_batch()
        torch.cuda.synchronize()
        stats["restage_s"] = time.perf_counter() - t0
        log(f"[htap] B: DELETE {n_del} rows {stats['delete_s']:.2f} s, UPDATE {n_upd} rows "
            f"{stats['update_s']:.2f} s, INSERT {HTAP_INSERT_ROWS} rows "
            f"{stats['insert_s']:.2f} s, COMMIT {stats['commit_s']:.2f} s; re-stage of the "
            f"image {stats['restage_s']:.2f} s")
        # the versioned path: counters at 0 just before, read just after
        reset_launches(gk)
        per_query = {}
        for who, sess, want_refs in (("pinned", a, refs), ("unpinned", b, post)):
            for q, sql in QUERIES.items():
                before = all_launches(gk)
                t0 = time.perf_counter()
                rows, spans, events = events_of(sess, sql)
                first_ms = (time.perf_counter() - t0) * 1e3
                got = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
                if got != EXPECTED_LAUNCHES[q]:
                    raise AssertionError(f"{who} ({q}) launched {got}, expected "
                                         f"{EXPECTED_LAUNCHES[q]}")
                check_query(q, rows, want_refs)
                snap = events.get("snapshot", {})
                if who == "pinned" and snap.get("versions_scanned", 0) <= 0:
                    raise AssertionError(f"pinned ({q}) did not read a versioned batch: {snap}")
                if who == "unpinned" and snap.get("versions_scanned", 0):
                    raise AssertionError(f"unpinned ({q}) read a versioned batch: {snap}")
                per_query[f"{who}_{q}"] = got
                stats[f"{who}_{q}"] = {"first_ms": first_ms, "launches": got,
                                       "versions_scanned": snap.get("versions_scanned", 0),
                                       "mvcc_visibility_ms": spans.get("mvcc.visibility", 0.0),
                                       **timed_query(sess, sql, HTAP_REPS)}
                if q == "a" and stats[f"{who}_{q}"]["index_add_kernels"]:
                    raise AssertionError(f"{who} (a) ran index_add_ on the card")
                st = stats[f"{who}_{q}"]
                log(f"[htap] {who} ({q}): first {first_ms:.1f} ms (mvcc.visibility "
                    f"{st['mvcc_visibility_ms']:.1f} ms, {st['versions_scanned']} history "
                    f"versions), warm p50 {st['warm_ms_p50']:.2f} ms p67 "
                    f"{st['warm_ms_p67']:.2f} ms, device {fmt(st['device_ms'], '.2f')} ms, idle "
                    f"{fmt(st['idle_share'], '.3f')}, launches {got}")
        launches = {k: sum(p.get(k, 0) for p in per_query.values()) for k in gk.LAUNCHES}
        launches["segment_reduce"] = sum(p.get("segment_reduce", 0) for p in per_query.values())
        stats["kernel_checks"] = versioned_kernel_checks(gk, store, a._snapshot[1], seed)
        a.execute("SET SNAPSHOT = 0")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[htap] pinned (a)-(c) equal phase 3's numpy, unpinned the post-write numpy; "
        f"peak {stats['peak_mem_gib']:.2f} GiB")
    return launches, stats


def durability_phase(gk, seed: int) -> tuple[dict, dict]:
    """Phase 11 (iii): ``Database(data_dir=...)`` on the card: a sysbench-
    shaped table of 100,000 rows written through the row tier (INSERT ...
    SELECT), sysbench transactions and a rolled-back one, no checkpoint; a
    new Database over the directory recovers the same rows and GROUP BY;
    then a checkpoint, more transactions, and recovery again."""
    import tempfile

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.models import sysbench as sb

    reset_launches(gk)
    probe = ("SELECT k % 16 m, COUNT(*) n, SUM(k) sk, MAX(id) mx FROM sbtest1 "
             "GROUP BY m ORDER BY m", "SELECT id, k, c, pad FROM sbtest1 ORDER BY id")
    stats = {"rows": DURABLE_ROWS}
    with tempfile.TemporaryDirectory() as d:
        s = Session(Database("cuda", data_dir=d))
        s.execute(sb.DDL)
        s.execute(sb.DDL.replace("sbtest1", "sbsrc").replace("k_1", "k_2"))
        s.load_arrow("sbsrc", sb.table(DURABLE_ROWS, seed + 3))
        # phase 14: a subscription and a view live through the writes and
        # the restarts
        s.execute("CREATE SUBSCRIPTION sbfeed ON sbtest1")
        s.execute(f"CREATE MATERIALIZED VIEW sbv AS {SB_VIEW}")
        t0 = time.perf_counter()
        s.execute("INSERT INTO sbtest1 SELECT * FROM sbsrc")
        stats["insert_select_s"] = time.perf_counter() - t0
        s.execute("DROP TABLE sbsrc")
        drv = sb.Driver(s, DURABLE_ROWS, seed + 3)
        drv.run(20)
        s.execute("BEGIN")
        s.execute("DELETE FROM sbtest1 WHERE k < 50000")
        s.execute("UPDATE sbtest1 SET c = 'gone' WHERE id < 100")
        s.execute("ROLLBACK")
        want = [s.query(q) for q in probe]
        pending = [(e.event_type, json.dumps(e.rows, default=str), e.statement, e.affected)
                   for e in s.db.cdc.get("sbfeed").fetch(1 << 30)]
        view = view_and_recompute(s, SB_VIEW + " ORDER BY k")
        for step in ("recover", "checkpoint"):
            t0 = time.perf_counter()
            s = Session(Database("cuda", data_dir=d))
            got = [s.query(q) for q in probe]
            stats[f"{step}_s"] = time.perf_counter() - t0
            if got != want:
                raise AssertionError(f"recovery after {step} differs from the rows written")
            if step == "recover":
                fetched = [(r["event_type"], r["rows"], r["statement"], r["affected"])
                           for r in s.query("FETCH 1000000 FROM sbfeed")]
                if fetched != pending:
                    raise AssertionError("the reopened data_dir's un-acked events differ")
                if view_and_recompute(s, SB_VIEW + " ORDER BY k") != view:
                    raise AssertionError("the reopened view answers differently")
                stats["events_after_recover"] = len(fetched)
                s.db.checkpoint()
                drv.session = s
                drv.run(20)
                want = [s.query(q) for q in probe]
        if want[1] != [{"id": i, "k": int(drv.reference.k[i]), "c": drv.reference.c[i],
                        "pad": drv.reference.pad[i]} for i in range(1, DURABLE_ROWS + 1)]:
            raise AssertionError("the recovered rows differ from the sysbench replay")
    launches = all_launches(gk)
    log(f"[durable] {DURABLE_ROWS} rows: recovered from the WAL in {stats['recover_s']:.2f} s "
        f"and from checkpoint + WAL in {stats['checkpoint_s']:.2f} s, same rows and GROUP BY; "
        f"the subscription's {stats['events_after_recover']} un-acked events and the view's "
        "answers came back")
    return launches, stats


SB_VIEW = "SELECT k, COUNT(*), SUM(id) FROM sbtest1 GROUP BY k"


def view_and_recompute(s, sql: str) -> list:
    """A view's answer, held equal to ``matview_answer = 0``'s."""
    rows = s.query(sql)
    with flag(s, "matview_answer", 0):
        if s.query(sql) != rows:
            raise AssertionError(f"the view's answer differs from the recompute: {sql}")
    return rows


# ----------------------------------------------------------------------
# phase 12: the plan cache, PREPARE / EXECUTE, the batched dispatcher with
# its lane-batched kernels, EXPLAIN ANALYZE

D_SHAPES = {
    "D-a": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > {x} GROUP BY g16",
    "D-b": ("SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t WHERE v*2+1 > {x} AND g >= {lo} "
            "AND g < {hi} GROUP BY g"),
    "D-c": "SELECT g, SUM(w), AVG(w) FROM t WHERE w > {x} AND g >= {lo} AND g < {hi} GROUP BY g",
}
D_CLIENTS = 64
D_PER_CLIENT = 4                 # 8 until PR 15; cut to keep the run within its limit
D_TICK_MS = 20.0                 # the combiner's wait for a group to fill
D_HOISTED = {"D-a": 3, "D-b": 5, "D-c": 3}
# each tick's launches: one a kernel call, every call over all lanes
D_TICK_LAUNCHES = {"D-a": {"segment_reduce_lanes": 8},
                   "D-b": {"partition_histogram_lanes": 1, "fused_group_aggregate_lanes": 1},
                   "D-c": {"filtered_group_sum_lanes": 1, "partition_histogram_lanes": 1}}
D_INLINE_LAUNCHES = {"D-a": EXPECTED_LAUNCHES["a"], "D-b": EXPECTED_LAUNCHES["b"],
                     "D-c": EXPECTED_LAUNCHES["c"]}
CACHE_VARIANTS = 30
CACHE_TPCH = ("q2", "q4", "q11", "q12", "q13", "q14", "q16", "q22")
CACHE_TPCH_REPS = 5
PREPARED_VALUES = 20


class ThresholdRefs:
    """float64 references of ``key(col) > x AND lo <= group < hi`` per
    group, for any x: the rows sorted by (group, value) once, each group's
    bounds and the float64 prefix sums of the sorted values and of their
    magnitudes (on the card: torch's sort, gather, ``searchsorted`` and
    ``cumsum``, none of the port's code; numpy gathered and summed them
    until PR 17), then per query a numpy binary search and prefix-sum
    differences a group.  ``key`` is monotone in the value, so each group's
    kept rows are a suffix of its sorted values."""

    def __init__(self, groups: np.ndarray, vals: np.ndarray, key, ng: int):
        g = torch.from_numpy(groups).cuda()
        x = torch.from_numpy(vals).cuda()
        o = torch.sort(x, stable=True).indices
        o = o[torch.sort(g[o], stable=True).indices]
        x, g = x[o], g[o]
        del o
        self.bounds = torch.searchsorted(
            g, torch.arange(ng + 1, dtype=g.dtype, device=g.device)).cpu().numpy()
        v64 = x.double()
        zero = v64.new_zeros(1)
        self.cs = torch.cat([zero, v64.cumsum(0)]).cpu().numpy()
        self.ca = torch.cat([zero, v64.abs().cumsum(0)]).cpu().numpy()
        self.v = x.cpu().numpy()
        del g, x, v64
        self.key = key(self.v)
        self.ng = ng

    def groups(self, x: float, lo: int = 0, hi: int | None = None) -> dict:
        """group -> (count, sum, sum |v|, min) of the kept rows."""
        out = {}
        for g in range(lo, self.ng if hi is None else min(hi, self.ng)):
            s, e = int(self.bounds[g]), int(self.bounds[g + 1])
            k = s + int(np.searchsorted(self.key[s:e], x, side="right"))
            if k < e:
                out[g] = (e - k, self.cs[e] - self.cs[k], self.ca[e] - self.ca[k],
                          float(self.v[k]))
        return out


def d_refs(table) -> dict:
    """The references of (a)/D-a, (b)/D-b and (c)/D-c over phase 3's table."""
    t0 = time.perf_counter()
    g = table.column("g").to_numpy()
    g16 = table.column("g16").to_numpy()
    v = table.column("v").to_numpy()
    w = table.column("w").to_numpy()

    def vkey(x):
        return (x * np.float32(2) + np.float32(1)).astype(np.float64)

    refs = {"D-a": ThresholdRefs(g16, v, vkey, 16), "D-b": ThresholdRefs(g, v, vkey, 2048),
            "D-c": ThresholdRefs(g, w, lambda x: x.astype(np.float64), 2048)}
    log(f"[phase12] threshold references built in {time.perf_counter() - t0:.1f} s")
    return refs


def check_threshold(name: str, rows, want: dict, has_count=True, has_min=True) -> None:
    """Group keys and counts exact, SUM within 1e-5 * sum(|v|) of its group,
    AVG within that over the count, MIN exact (against ``ThresholdRefs``)."""
    cols = list(rows[0]) if rows else []
    rows = sorted(rows, key=lambda r: r[cols[0]])
    if [r[cols[0]] for r in rows] != sorted(want):
        raise AssertionError(f"{name}: group keys differ from numpy")
    for r in rows:
        g, *vals = (r[c] for c in cols)
        cnt, sm, sabs, mn = want[g]
        if has_count:
            if vals[0] != cnt:
                raise AssertionError(f"{name} group {g}: count {vals[0]} != {cnt}")
            vals = vals[1:]
        tol = 1e-5 * sabs + 1e-12
        if abs(vals[0] - sm) > tol or abs(vals[1] - sm / cnt) > tol / cnt:
            raise AssertionError(f"{name} group {g}: sum/avg {vals[0]}/{vals[1]} vs "
                                 f"{sm}/{sm / cnt}")
        if has_min and vals[2] != mn:
            raise AssertionError(f"{name} group {g}: min {vals[2]} != {mn}")


def check_d(name: str, sql_args: dict, rows, refs) -> None:
    want = refs[name].groups(sql_args["x"], sql_args.get("lo", 0), sql_args.get("hi"))
    check_threshold(f"{name} {sql_args}", rows, want, has_count=name != "D-c",
                    has_min=name != "D-c")


def d_statements(name: str, seed: int) -> list:
    """Each client's D_PER_CLIENT statements of shape ``name`` with its own
    literals -> [[(sql, args), ...] a client].  D-b's ranges hold at most
    100 groups, but client 0's first holds 200: past the 128-row scatter
    budget, so its lane re-runs inline."""
    rng = np.random.default_rng(seed + len(name) * 7919)
    out = []
    for c in range(D_CLIENTS):
        mine = []
        for k in range(D_PER_CLIENT):
            args = {"x": round(float(rng.normal()) * 0.5, 3)}
            if name != "D-a":
                width = 200 if (name == "D-b" and c == 0 and k == 0) else \
                    int(rng.integers(20, 101))
                args["lo"] = int(rng.integers(0, 2048 - width))
                args["hi"] = args["lo"] + width
            mine.append((D_SHAPES[name].format(**args), args))
        out.append(mine)
    return out


def cache_phase(gk, single, refs) -> dict:
    """Phase 12 (i): (a)-(c) with CACHE_VARIANTS literal variants of their
    WHERE threshold, the plan cache on and with ``plan_cache_size = 0``:
    warm p50 / p67, the spans of a traced pass, the counter deltas; every
    variant's rows against numpy."""
    from baikaldb_tpu_torch.obs import trace
    from baikaldb_tpu_torch.utils import metrics

    s = single
    forms = {"a": ("D-a", QUERIES["a"].replace("0.5", "{x}")),
             "b": ("D-b", QUERIES["b"].replace("0.5", "{x}")),
             "c": ("D-c", QUERIES["c"].replace("-1", "{x}"))}
    rng = np.random.default_rng(12)
    out = {}
    for q, (ref, form) in forms.items():
        xs = [round(float(x), 4) for x in rng.normal(size=CACHE_VARIANTS) * 0.5]
        sqls = [form.format(x=x) for x in xs]
        res = {"on": {"walls": [], "first_ms": []}, "off": {"walls": [], "first_ms": []}}
        # in turns (on, off, on, off): a difference is not the order's
        for mode, size in (("on", 256), ("off", 0), ("on", 256), ("off", 0)):
            r = res[mode]
            with flag(s, "plan_cache_size", size):
                c0 = (metrics.plan_cache_hits.value, metrics.plan_cache_param_hits.value,
                      metrics.plan_cache_misses.value)
                walls = []
                for sql, x in zip(sqls, xs):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rows = s.query(sql)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t) * 1e3)
                    check_d(ref, {"x": x}, rows, refs)
                c1 = (metrics.plan_cache_hits.value, metrics.plan_cache_param_hits.value,
                      metrics.plan_cache_misses.value)
                r["first_ms"].append(walls[0])
                r["walls"] += walls[1:]
                r.setdefault("counters", []).append(
                    {"hits": c1[0] - c0[0], "param_hits": c1[1] - c0[1],
                     "misses": c1[2] - c0[2]})
                if "span_ms" in r:
                    continue
                # one traced pass: the host ms of the planning spans a query
                with flag(s, "tracing", 1):
                    for sql in sqls:
                        s.query(sql)
                spans: dict = {}
                for rec in trace.TRACER.list()[-len(sqls):]:
                    for sp in rec["spans"]:
                        if sp["name"].startswith("plan."):
                            spans.setdefault(sp["name"], []).append(sp["dur_ms"])
                r["span_ms"] = {k: {"n": len(v), "mean": statistics.fmean(v)}
                                for k, v in spans.items()}
        for r in res.values():
            warm = sorted(r.pop("walls"))
            r.update(warm_ms_p50=statistics.median(warm),
                     warm_ms_p67=float(np.percentile(warm, 67)), runs=len(warm))
        on = res["on"]
        # every variant hits an entry with its own literal (a param hit);
        # a negative threshold is its own shape (``neg`` wraps the literal)
        for c in on["counters"]:
            if c["misses"] > 1 or c["param_hits"] < CACHE_VARIANTS - 1:
                raise AssertionError(f"({q}) with the plan cache: {on}")
        if any(c["misses"] != CACHE_VARIANTS for c in res["off"]["counters"]):
            raise AssertionError(f"({q}) with plan_cache_size = 0: {res['off']}")
        out[q] = res
        log(f"[phase12] (i) ({q}) {CACHE_VARIANTS} variants: cache on p50 "
            f"{on['warm_ms_p50']:.2f} / p67 {on['warm_ms_p67']:.2f} ms, off "
            f"{res['off']['warm_ms_p50']:.2f} / {res['off']['warm_ms_p67']:.2f} ms; "
            f"spans on {on['span_ms']}, off {res['off']['span_ms']}; counters on "
            f"{on['counters']}")
    return out


def prepared_phase(single, refs) -> dict:
    """Phase 12 (ii): (b) PREPAREd with a ``?`` threshold, EXECUTEd with
    PREPARED_VALUES values (a user variable, a literal in turn), each
    against numpy."""
    from baikaldb_tpu_torch.utils import metrics

    s = single
    s.execute("PREPARE pb FROM 'SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t "
              "WHERE v*2+1 > ? GROUP BY g ORDER BY g'")
    rng = np.random.default_rng(13)
    e0 = metrics.prepared_executes.value
    walls = []
    for i, x in enumerate(round(float(x), 4) for x in rng.normal(size=PREPARED_VALUES)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i % 2:
            s.execute(f"SET @thr = {x}")
            rows = s.query("EXECUTE pb USING @thr")
        else:
            rows = s.query(f"EXECUTE pb USING {x}")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        check_d("D-b", {"x": x}, rows, refs)
    s.execute("DEALLOCATE PREPARE pb")
    if metrics.prepared_executes.value - e0 != PREPARED_VALUES:
        raise AssertionError("prepared_executes did not count every EXECUTE")
    out = {"executes": PREPARED_VALUES, "first_ms": walls[0],
           "warm_ms_p50": statistics.median(walls[1:])}
    log(f"[phase12] (ii) EXECUTE of (b) with {PREPARED_VALUES} values equal numpy: {out}")
    return out


def run_clients(db, per_client: list, barrier_timeout: float = 600.0) -> tuple:
    """Each client's statements on its own Session and thread, started
    behind one barrier -> ({sql: arrow}, per-statement ms, wall s)."""
    from baikaldb_tpu_torch.exec.session import Session

    sessions = [Session(db) for _ in per_client]
    out, lat, errs = {}, [], []
    start = threading.Barrier(len(per_client) + 1)

    def worker(s, mine):
        start.wait(barrier_timeout)
        for sql, _args in mine:
            try:
                t = time.perf_counter()
                out[sql] = s.execute(sql).arrow
                lat.append((time.perf_counter() - t) * 1e3)
            except BaseException as e:      # noqa: BLE001 — re-raised below
                errs.append(e)

    ts = [threading.Thread(target=worker, args=(s, m)) for s, m in zip(sessions, per_client)]
    for t in ts:
        t.start()
    start.wait(barrier_timeout)
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return out, lat, wall


@contextlib.contextmanager
def compared_lane_kernels(before):
    """The compared commit's K1/K3/K2 and segment lane entries in this
    port's lane program (ops/hashagg.py's names and the segments module's),
    for a tick timed before and after in one call."""
    from baikaldb_tpu_torch.ops import hashagg
    from baikaldb_tpu_torch.ops import segments as seg

    names = ("filtered_group_sum_lanes", "fused_group_aggregate_lanes",
             "partition_histogram_lanes")
    saved = {k: getattr(hashagg, k) for k in names}, seg.segment_reduce_lanes
    for k in names:
        setattr(hashagg, k, getattr(before, k))
    seg.segment_reduce_lanes = compared_segments(before).segment_reduce_lanes
    try:
        yield
    finally:
        for k, f in saved[0].items():
            setattr(hashagg, k, f)
        seg.segment_reduce_lanes = saved[1]


def tick_breakdown(gk, s, statements: list, serial: dict) -> dict:
    """One tick of ``statements`` through the lane program directly (what
    the leader runs): wall p50 of 3, device ms and idle share of one
    profiled tick, its launches; each lane's rows equal the serial ones
    (an overflowed lane aside)."""
    from baikaldb_tpu_torch.exec import lanes
    from baikaldb_tpu_torch.plan import paramize
    from baikaldb_tpu_torch.sql.parser import parse_sql

    norms = [paramize.normalize(parse_sql(sql)[0], s._param_resolver(parse_sql(sql)[0]))
             for sql, _ in statements]
    plan = s._plan_select(norms[0].stmt)
    batches, _, _ = s._collect_batches(plan)
    feeds = [paramize.bind(n.slots, batches) for n in norms]
    G = len(feeds)
    gpad = max(2, 1 << (G - 1).bit_length())
    feeds += [feeds[0]] * (gpad - G)
    stacked = tuple(np.stack([np.reshape(f[i], -1) for f in feeds]) for i in range(len(feeds[0])))
    prog = lanes.LaneProgram(plan, s.device)
    cap = 128

    def tick():
        return lanes.rebuild_clients(prog.run(batches, stacked, cap), G)

    outs = tick()
    overflowed = 0
    for (sql, _), o in zip(statements, outs):
        if serial[sql].num_rows > cap:
            # past the scatter budget: the lane comes back empty (its member
            # re-runs inline in a real tick)
            if o is not None:
                raise AssertionError(f"a lane over the scatter budget came back: {sql}")
            overflowed += 1
        elif o is None or not o.to_arrow().equals(serial[sql]):
            raise AssertionError(f"a lane of the profiled tick differs from its serial run: "
                                 f"{sql}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tick()
        walls.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(walls)
    before = lane_launches(gk)
    tick()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in lane_launches(gk).items() if v != before[k]}
    return {"lanes": G, "padded": gpad, "overflowed_lanes": overflowed, "wall_ms_p50": med,
            "launches": launched, **device_breakdown(tick, med, host_ops=False)}


def dispatch_phase(gk, single, refs, seed: int, before=None) -> dict:
    """Phase 12 (iii): D_CLIENTS sessions on as many threads, each sending
    D_PER_CLIENT statements of each shape with its own literals; against
    the same statements one after another on one session."""
    from baikaldb_tpu_torch.exec import dispatch
    from baikaldb_tpu_torch.utils import metrics
    from baikaldb_tpu_torch.utils.flags import FLAGS

    s = single
    db = s.db
    out = {"clients": D_CLIENTS, "per_client": D_PER_CLIENT, "tick_ms": D_TICK_MS,
           "max_group": int(FLAGS.batch_dispatch_max_group),
           "scatter_rows": int(FLAGS.batch_dispatch_scatter_rows)}
    for name in D_SHAPES:
        per_client = d_statements(name, seed)
        flat = [st for mine in per_client for st in mine]
        # the serial baseline: one session, one statement after another
        serial, lat_s = {}, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for sql, _ in flat:
            t = time.perf_counter()
            serial[sql] = s.execute(sql).arrow
            lat_s.append((time.perf_counter() - t) * 1e3)
        serial_s = time.perf_counter() - t0
        for sql, args in flat:
            check_d(name, args, serial[sql].to_pylist(), refs)
        # the concurrent run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for m in (metrics.queue_wait_ms, metrics.dispatch_tick_ms, metrics.group_occupancy):
            m.reset()
        occ0 = dict(db.dispatcher.occupancy)
        c0 = {k: getattr(metrics, k).value
              for k in ("batched_groups", "dispatch_inline", "dispatch_fallbacks")}
        reset_launches(gk)
        with flag(s, "batch_dispatch_tick_ms", D_TICK_MS):
            got, lat_c, conc_s = run_clients(db, per_client)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        c1 = {k: getattr(metrics, k).value - c0[k] for k in c0}
        lanes_n = lane_launches(gk)
        inline_n = all_launches(gk)
        ticks = c1["batched_groups"]
        occ = {k: v - occ0.get(k, 0) for k, v in db.dispatcher.occupancy.items()
               if v != occ0.get(k, 0)}
        bad = [sql for sql, _ in flat if not got[sql].equals(serial[sql])]
        if bad:
            raise AssertionError(f"{name}: {len(bad)} clients' rows differ from their serial "
                                 f"run, e.g. {bad[0]}")
        if ticks < 1:
            raise AssertionError(f"{name}: no batched tick formed")
        for k, n in D_TICK_LAUNCHES[name].items():
            if lanes_n[k] != n * ticks:
                raise AssertionError(f"{name}: {k} launched {lanes_n[k]} times over {ticks} "
                                     f"ticks, expected {n} a tick")
        extra = {k: v for k, v in lanes_n.items() if v and k not in D_TICK_LAUNCHES[name]}
        if extra:
            raise AssertionError(f"{name}: unexpected lane launches {extra}")
        overflow = sum(1 for sql, _ in flat
                       if serial[sql].num_rows > int(FLAGS.batch_dispatch_scatter_rows))
        if c1["dispatch_fallbacks"] > overflow:
            raise AssertionError(f"{name}: {c1['dispatch_fallbacks']} members fell back "
                                 f"inline, {overflow} lanes overflowed")
        # the members that ran inline (bypass, solo ticks, fallbacks) ran the
        # one-lane kernels; nothing else launched them
        inline_runs = len(flat) - sum(k * v for k, v in occ.items()) + c1["dispatch_fallbacks"]
        for k, n in D_INLINE_LAUNCHES[name].items():
            if inline_n[k] != n * inline_runs:
                raise AssertionError(f"{name}: {k} launched {inline_n[k]} times for "
                                     f"{inline_runs} inline runs")
        firsts = [mine[0] for mine in per_client]
        tick = tick_breakdown(gk, s, firsts, serial)
        tick.pop("kernel_names", None)
        if before is not None:
            # the compared commit's lane kernels in this lane program, in turns
            ticks_dev = {"before": [], "this": [tick["device_ms"]]}
            k2_dev = {"before": [], "this": [tick["k2_device_ms"]]}
            for who in ("before", "this", "before"):
                with (compared_lane_kernels(before) if who == "before"
                      else contextlib.nullcontext()):
                    t = tick_breakdown(gk, s, firsts, serial)
                ticks_dev[who].append(t["device_ms"])
                k2_dev[who].append(t["k2_device_ms"])
            tick["device_ms_in_turns"] = ticks_dev
            tick["k2_device_ms_in_turns"] = k2_dev
        qw = metrics.queue_wait_ms.stats()
        tk = metrics.dispatch_tick_ms.stats()
        out[name] = {
            "statements": len(flat),
            "serial_wall_s": serial_s, "serial_stmt_per_s": len(flat) / serial_s,
            "serial_ms": percentiles(lat_s),
            "concurrent_wall_s": conc_s, "concurrent_stmt_per_s": len(flat) / conc_s,
            "concurrent_ms": percentiles(lat_c),
            "ticks": ticks, "occupancy": {str(k): v for k, v in sorted(occ.items())},
            "dispatch_inline": c1["dispatch_inline"],
            "dispatch_fallbacks": c1["dispatch_fallbacks"], "overflow_lanes": overflow,
            "queue_wait_p50_ms": qw["p50_ms"], "tick_ms": tk,
            "lane_launches": {k: v for k, v in lanes_n.items() if v},
            "lane_launches_per_tick": {k: v / ticks for k, v in lanes_n.items() if v},
            "inline_launches": {k: v for k, v in inline_n.items() if v},
            "peak_mem_gib": peak, "profiled_tick": tick}
        log(f"[phase12] (iii) {name}: serial {serial_s:.2f} s ({len(flat) / serial_s:.1f} "
            f"stmt/s), concurrent {conc_s:.2f} s ({len(flat) / conc_s:.1f} stmt/s); "
            f"{ticks} ticks {out[name]['occupancy']}, inline {c1['dispatch_inline']}, "
            f"fallbacks {c1['dispatch_fallbacks']}, queue wait p50 {qw['p50_ms']} ms; "
            f"lane launches {out[name]['lane_launches']}; tick of {tick['lanes']} lanes "
            f"{tick['wall_ms_p50']:.2f} ms wall, {fmt(tick['device_ms'], '.2f')} device (K2 "
            f"{fmt(tick['k2_device_ms'], '.2f')}), idle {fmt(tick['idle_share'], '.3f')}; "
            f"peak {peak:.2f} GiB")
        if not dispatch.enabled():
            raise AssertionError("the dispatcher is off")
    return out


def explain_phase(single, refs) -> dict:
    """Phase 12 (v): EXPLAIN ANALYZE of (a)-(c) on the card: the scan's and
    the aggregate's live rows equal numpy's counts; the ``-- dispatch`` and
    ``-- params`` lines are there."""
    s = single
    out = {}
    for q, ref in (("a", "D-a"), ("b", "D-b"), ("c", "D-c")):
        x = {"a": 0.5, "b": 0.5, "c": -1.0}[q]
        want = refs[ref].groups(x)
        lines = [r["plan"] for r in s.query("EXPLAIN ANALYZE " + QUERIES[q])]
        rows = {ln.strip().split("(")[0]: int(ln.rsplit("rows=", 1)[1]) for ln in lines
                if "rows=" in ln}
        live = sum(c for c, *_ in want.values())
        if rows.get("Scan") != live or rows.get("Agg") != len(want):
            raise AssertionError(f"EXPLAIN ANALYZE ({q}): {rows}, numpy {live} rows in "
                                 f"{len(want)} groups")
        for prefix in ("-- dispatch:", "-- params:", "-- run:", "-- trace:"):
            if not any(ln.startswith(prefix) for ln in lines):
                raise AssertionError(f"EXPLAIN ANALYZE ({q}) has no {prefix} line")
        out[q] = [ln for ln in lines if ln.startswith("-- ")]
    # the dispatcher's literals are hoisted, not pinned
    for name, form in D_SHAPES.items():
        lines = [r["plan"] for r in s.query("EXPLAIN ANALYZE " + form.format(x=0.25, lo=10,
                                                                              hi=60))]
        line = next(ln for ln in lines if ln.startswith("-- params:"))
        if f"hoisted={D_HOISTED[name]} pinned=0" not in line:
            raise AssertionError(f"{name}: {line}")
        out[name] = line
    log(f"[phase12] (v) EXPLAIN ANALYZE live rows equal numpy; {out}")
    return out


def lane_case(gk, seg, n: int, ng: int, G: int, gen, *, nans=False,
              plain_lanes=None) -> float:
    """K1, K2, K3 and the segment kernel over G lanes on one input (lane 1
    all dead, lane 2 one live row): every lane against the one-lane kernels
    on its mask (the segment kernel bit for bit), and the lanes
    ``plain_lanes`` (all when None) against the plain versions; counts
    exact, MIN/MAX exact (NaN equal), sums as ``check_case``; -> max |err|."""
    dev = torch.device("cuda")
    codes, values, _ = make_inputs(n, ng, gen, dev, nans=nans)
    # lane by lane: one [G, n] float32 draw at 64 lanes of 100M rows is 25.6 GB
    mask = torch.empty((G, n), dtype=torch.bool, device=dev)
    for g in range(G):
        mask[g] = torch.rand(n, generator=gen, device=dev) < 0.6
    if G > 2:
        mask[1] = False
        mask[2] = False
        mask[2, n // 2] = True
    if nans:
        mask[3:, 100:133] = True          # the NaN groups live in lanes 3 and up
    where = f"(lanes n={n} ng={ng} G={G})"
    plain_lanes = range(G) if plain_lanes is None else [g for g in plain_lanes if g < G]
    w64 = values.to(torch.float64)
    k1 = gk.filtered_group_sum_lanes(codes, w64, mask, ng)
    k2 = gk.fused_group_aggregate_lanes(codes, values, mask, ng)
    k3 = gk.partition_histogram_lanes(codes, mask, ng)
    torch.cuda.synchronize()
    err = 0.0

    def sums_close(what, got, want, tol):
        ok = torch.isfinite(want)
        if not same(got[~ok], want[~ok]):
            raise AssertionError(f"{what}: NaN or inf differs {where}")
        d = (got[ok].double() - want[ok].double()).abs()
        if bool((d > tol[ok]).any()):
            raise AssertionError(f"{what} beyond 1e-5*sum|v| {where}")
        return float(d.max()) if d.numel() else 0.0

    for g in range(G):
        m = mask[g]
        live = m & (codes >= 0) & (codes < ng)
        gid = torch.where(live, codes, ng).long()
        sabs = torch.zeros(ng + 1, dtype=torch.float64, device=dev)
        sabs.index_add_(0, gid, values.abs().double().nan_to_num(0.0))
        tol = 1e-5 * sabs[:ng]
        refs = {"kernel": (gk.filtered_group_sum(codes, w64, m, ng),
                           gk.fused_group_aggregate(codes, values, m, ng),
                           gk.partition_histogram(codes, m, ng))}
        if g in plain_lanes:
            refs["plain version"] = (gk.filtered_group_sum_plain(codes, w64, m, ng),
                                     gk.fused_group_aggregate_plain(codes, values, m, ng),
                                     gk.partition_histogram_plain(codes, m, ng))
        for ref, (p1, p2, p3) in refs.items():
            for what, got, want in (("K3 counts", k3[g], p3), ("K1 counts", k1[0][g], p1[0]),
                                    ("K2 counts", k2[0][g], p2[0]),
                                    ("K2 mins", k2[2][g], p2[2]), ("K2 maxs", k2[3][g], p2[3])):
                if not same(got, want):
                    raise AssertionError(f"{what} of lane {g} differ from the one-lane {ref} "
                                         f"{where}")
            for what, got, want in (("K1 sums", k1[1][g], p1[1]), ("K2 sums", k2[1][g], p2[1])):
                err = max(err, sums_close(f"{what} of lane {g} against the {ref}", got, want,
                                          tol))
    # the segment kernel: SUM of a float64 column, MIN of float32, an int32
    # count and D-a's COUNT(*) (int64 ones), over min(ng, 17) segments
    # (dense ids, as a group-by's)
    S = min(ng, NG_A)
    gid = torch.remainder(codes, S).to(torch.int32)
    for x, op in ((w64, "sum"), (values, "min"), (values, "max"),
                  (torch.ones(n, dtype=torch.int32, device=dev), "sum"),
                  (torch.ones(n, dtype=torch.int64, device=dev), "sum")):
        got = seg.segment_reduce_lanes(x, gid, mask, S, op)
        torch.cuda.synchronize()
        for g in range(G):
            ids = torch.where(mask[g], gid, S)
            # the lane kernel runs the one-lane plan: bit-identical to it
            if not same(got[g], seg.segment_reduce(x, ids, S, op)):
                raise AssertionError(f"segment {op} {x.dtype} lane {g} differs from the "
                                     f"one-lane kernel {where}")
            if g in plain_lanes:
                err = max(err, seg_check(seg, x, ids, S, op, got=got[g]))
    return err


def lane_edges(fit: int) -> list:
    """Lane counts around a tile of ``fit`` lanes and the ticks' 64."""
    return sorted({1, max(1, fit - 1), fit + 1, 63, 64, 65})


def k2_lanes_check(gk, codes, values, mask, ng: int, where: str) -> float:
    """Every lane of K2's lane entry against the one-lane kernel and the
    plain version on its mask: counts, MIN and MAX exact (NaN equal), sums
    within 1e-5 * sum|v| of the lane's group; -> max |err|."""
    got = gk.fused_group_aggregate_lanes(codes, values, mask, ng)
    torch.cuda.synchronize()
    err = 0.0
    for g in range(mask.shape[0]):
        one = gk.fused_group_aggregate(codes, values, mask[g], ng)
        plain = gk.fused_group_aggregate_plain(codes, values, mask[g], ng)
        for k, what in ((0, "counts"), (2, "mins"), (3, "maxs")):
            if not (same(got[k][g], one[k]) and same(got[k][g], plain[k])):
                raise AssertionError(f"K2 lane tile {what} of lane {g} differ from the one-lane "
                                     f"kernel or the plain version {where}")
        live = mask[g] & (codes >= 0) & (codes < ng)
        sabs = torch.zeros(ng + 1, dtype=torch.float64, device=codes.device)
        sabs.index_add_(0, torch.where(live, codes, ng).long(),
                        values.abs().double().nan_to_num(0.0))
        ok = torch.isfinite(plain[1])
        if not same(got[1][g][~ok], plain[1][~ok]):
            raise AssertionError(f"K2 lane tile sums of lane {g}: NaN or inf differs {where}")
        d = (got[1][g][ok].double() - plain[1][ok].double()).abs()
        if bool((d > 1e-5 * sabs[:ng][ok]).any()):
            raise AssertionError(f"K2 lane tile sums of lane {g} beyond 1e-5*sum|v| {where}")
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def lane_edge_cases(gk, seg, gen) -> float:
    """The lane tiles' edges: the segment kernel in each table layout
    (private at 17 slots, warp at 2,048, block at 16,384), K1/K3 at 2049
    slots and K2 at 37, 2049 and 4096 slots, over lane counts around each
    tile (``lane_edges``), on ragged row counts with an all-dead lane and NaN
    in MIN/MAX; K2 also with every code in one slot and at D-b's ~2% live.
    Every segment lane equals the one-lane
    kernel in the same layout bit for bit (float64 sums of whole numbers in
    the warp and block layouts, whose shared atomics add in no fixed order;
    any values in the private one), and at 64 lanes three lanes equal the
    plain version; every K1/K3 lane equals the plain version (counts
    exactly, sums within 1e-5 * sum|v|) and K3's the one-lane kernel; every
    K2 lane equals the one-lane kernel and the plain version (counts, MIN
    and MAX exactly, sums within 1e-5 * sum|v|); -> max |err|."""
    from baikaldb_tpu_torch.bench.lane_tiles import masks

    dev = torch.device("cuda")
    err = 0.0
    for mode, S, n in (("private", NG_A, 1_000_003), ("warp", 2048, 1_000_003),
                       ("block", 16384, 100_003)):
        gid = torch.randint(-1, S + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        v = torch.randn(n, generator=gen, device=dev, dtype=torch.float64) * 1e3
        f32 = v.float()
        f32.view(torch.int32)[7:9] = torch.tensor([PLUS_NAN, MINUS_NAN], dtype=torch.int32,
                                                  device=dev)
        for x, op in ((v if mode == "private" else v.round(), "sum"),
                      (torch.ones(n, dtype=torch.int64, device=dev), "sum"),
                      (f32, "min"), (f32, "max")):
            for G in lane_edges(seg.lane_plan(op, x.dtype, S, 1, mode).fit):
                mask = torch.rand((G, n), generator=gen, device=dev) < 0.6
                mask[G // 2] = False
                got = seg.segment_reduce_lanes(x, gid, mask, S, op, mode=mode)
                torch.cuda.synchronize()
                for g in range(G):
                    ids = torch.where(mask[g], gid, S)
                    if not same(got[g], seg.segment_reduce(x, ids, S, op, mode=mode)):
                        raise AssertionError(f"segment {op} {x.dtype} {mode} S={S} G={G}: "
                                             f"lane {g} differs from the one-lane kernel")
                    if G == 64 and g in (0, G // 2, G - 1):
                        err = max(err, seg_check(seg, x, ids, S, op, got=got[g]))
        log(f"[phase12] (iv) segment lane tiles, {mode} tables at S={S} n={n}: every lane "
            f"bit-identical to the one-lane kernel")
    n, ng = 1_000_003, NG_SQL
    codes, values, _ = make_inputs(n, ng, gen, dev)
    w64 = values.double()
    fits = {gk.lane_plan(k, ng, 1).fit for k in (gk.KIND_SUM, gk.KIND_HIST)}
    for G in sorted(set().union(*(lane_edges(f) for f in fits))):
        mask = torch.rand((G, n), generator=gen, device=dev) < 0.6
        mask[G // 2] = False
        k1 = gk.filtered_group_sum_lanes(codes, w64, mask, ng)
        k3 = gk.partition_histogram_lanes(codes, mask, ng)
        torch.cuda.synchronize()
        for g in range(G):
            p1 = gk.filtered_group_sum_plain(codes, w64, mask[g], ng)
            p3 = gk.partition_histogram_plain(codes, mask[g], ng)
            if not (same(k3[g], p3) and same(k1[0][g], p1[0])
                    and same(k3[g], gk.partition_histogram(codes, mask[g], ng))):
                raise AssertionError(f"K1/K3 lane tiles: counts of lane {g} of {G} differ "
                                     f"from the plain version or the one-lane kernel")
            live = mask[g] & (codes >= 0) & (codes < ng)
            sabs = torch.zeros(ng + 1, dtype=torch.float64, device=dev)
            sabs.index_add_(0, torch.where(live, codes, ng).long(), w64.abs())
            d = (k1[1][g].double() - p1[1].double()).abs()
            if bool((d > 1e-5 * sabs[:ng]).any()):
                raise AssertionError(f"K1 lane tiles: sums of lane {g} of {G} beyond tolerance")
            err = max(err, float(d.max()))
    log(f"[phase12] (iv) K1/K3 lane tiles at {sorted(fits)} lanes a block: match")
    for ng, n in ((NG_SQL, 1_000_003), (4096, 100_003), (37, 100_003)):
        codes, values, _ = make_inputs(n, ng, gen, dev, nans=True)
        fit = gk.lane_plan(gk.KIND_AGG, ng, 1).fit
        for G in lane_edges(fit):
            mask = torch.rand((G, n), generator=gen, device=dev) < 0.6
            mask[:, 100:133] = True               # the NaN groups live in every lane
            mask[G // 2] = False
            err = max(err, k2_lanes_check(gk, codes, values, mask, ng, f"(ng={ng} G={G})"))
        log(f"[phase12] (iv) K2 lane tiles at {fit} lanes a block, ng={ng}: match")
    n = 1_000_003
    codes, values, _ = make_inputs(n, NG_SQL, gen, dev)
    mask = torch.rand((9, n), generator=gen, device=dev) < 0.6
    err = max(err, k2_lanes_check(gk, torch.full_like(codes, 5), values, mask, NG_SQL,
                                  "(every code in one slot)"))
    err = max(err, k2_lanes_check(gk, codes, values, masks("D-b", n, 9, codes, values, gen),
                                  NG_SQL, "(D-b masks)"))
    log("[phase12] (iv) K2 lane tiles with every code in one slot and at D-b's masks: match")
    return err


def lane_library_ms(mask, ids, src, ng: int, dtype, chunk: int = 8) -> tuple[float, int]:
    """The library call beside a lane kernel: ``index_add_`` of ``src`` over
    lane-offset ids (``ids`` where ``mask``, else ``ng``), timed once a chunk
    of ``chunk`` lanes: one call over 64 lanes of 100M rows would need 77 GB
    of ids and values -> (milliseconds summed, calls)."""
    G, n = mask.shape
    total, calls = 0.0, 0
    for a in range(0, G, chunk):
        k = min(chunk, G - a)
        lane_ids = (torch.where(mask[a:a + k], ids, ng).long()
                    + torch.arange(k, device=ids.device)[:, None] * (ng + 1)).reshape(-1)
        wide = src.expand(k, n).reshape(-1)
        acc = torch.zeros(k * (ng + 1), dtype=dtype, device=ids.device)
        total += cuda_ms(lambda: acc.index_add_(0, lane_ids, wide), 1)
        calls += 1
        del lane_ids, wide, acc
    return total, calls


def lane_kernel_phase(gk, rows: int, seed: int, before=None) -> dict:
    """Phase 12 (iv): the lane-batched kernels against their plain versions
    and the one-lane kernels at ``rows`` rows with G = 8 and 64 (the 64-lane
    ticks of (iii) at their slot counts) and at 10,000,019 (odd) rows with G
    = 64, with empty and all-dead lanes, NaN in MIN/MAX and a group of more
    than 2^24 rows; the lane tiles' edges (``lane_edge_cases``); then timed
    at G = 8 and 64 over ``rows`` rows and at 64 over the odd length against
    the byte bound (the lanes' masks plus one read of codes and values),
    with ``before`` (the compared commit's group_kernels) in turns."""
    from baikaldb_tpu_torch.bench.lane_tiles import alloc_bytes, lane_rows, masks
    from baikaldb_tpu_torch.ops import segments as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    t0 = time.perf_counter()
    small = 10_000_019
    err = 0.0
    # at 100M rows x 64 lanes the plain versions (per-lane loops) take a few
    # lanes; every lane meets the one-lane kernels
    for n, ng, G, kw in ((rows, NG_SQL, 8, {}), (small, NG_SQL, 64, {"nans": True}),
                         (small, 4, 8, {}), (small, NG_A, 64, {}),
                         (rows, NG_SQL, 64, {"plain_lanes": (0, 1, 2, 3, 63)}),
                         (rows, NG_A, 64, {"plain_lanes": (0, 1, 2, 3, 63)})):
        err = max(err, lane_case(gk, seg, n, ng, G, gen, **kw))
        torch.cuda.empty_cache()
        log(f"[phase12] (iv) lanes n={n} ng={ng} G={G} {kw or ''}: match "
            f"({time.perf_counter() - t0:.1f} s)")
    err = max(err, lane_edge_cases(gk, seg, gen))
    torch.cuda.empty_cache()
    # a group above 2^24 rows in every lane: exact int64 counts
    n = (1 << 24) + 5
    codes = torch.zeros(n, dtype=torch.int32, device=dev)
    mask = torch.ones((4, n), dtype=torch.bool, device=dev)
    mask[3, :10] = False
    for name, counts in (("K1", gk.filtered_group_sum_lanes(codes, torch.ones(n, device=dev),
                                                            mask, 2)[0]),
                         ("K2", gk.fused_group_aggregate_lanes(codes, torch.ones(n, device=dev),
                                                               mask, 2)[0]),
                         ("K3", gk.partition_histogram_lanes(codes, mask, 2))):
        if counts[:, 0].tolist() != [n, n, n, n - 10]:
            raise AssertionError(f"{name} lane counts {counts[:, 0].tolist()}")
    del codes, mask
    out = {"max_abs_err": err, "check_s": time.perf_counter() - t0}
    bseg = None if before is None else compared_segments(before)
    for n, G in ((rows, 8), (rows, 64), (small, 64)):
        codes, values, _ = make_inputs(n, NG_SQL, gen, dev)
        w64 = values.double()
        mask = torch.empty((G, n), dtype=torch.bool, device=dev)
        for g in range(G):
            mask[g] = torch.rand(n, generator=gen, device=dev) < 0.6
        gid17 = torch.remainder(codes, NG_A).to(torch.int32)
        live = lane_rows(mask)
        # over 8e8 lane-rows (``rows`` x 64) neither the plain versions (per-lane
        # loops, 1-7 s a call there) nor the library calls are timed: the
        # checks above hold every kernel to them at that size, and the
        # kernels line reads ``rows`` x 8
        big = G * n > 8 * 10**8
        specs = {
            # name: (the call given the module, the plain version, the library
            #        call's ids, values, slots and accumulator dtype, value
            #        bytes a row, output bytes a lane)
            "filtered_group_sum_lanes": (
                lambda m: m.filtered_group_sum_lanes(codes, w64, mask, NG_SQL),
                lambda: gk.filtered_group_sum_lanes_plain(codes, w64, mask, NG_SQL),
                (codes, w64, NG_SQL, torch.float64), 8, NG_SQL * 12),
            "fused_group_aggregate_lanes": (
                lambda m: m.fused_group_aggregate_lanes(codes, values, mask, NG_SQL),
                lambda: gk.fused_group_aggregate_lanes_plain(codes, values, mask, NG_SQL),
                None, 4, NG_SQL * 20),
            "partition_histogram_lanes": (
                lambda m: m.partition_histogram_lanes(codes, mask, NG_SQL),
                lambda: gk.partition_histogram_lanes_plain(codes, mask, NG_SQL),
                (codes, torch.ones(n, device=dev), NG_SQL, torch.float32), 0, NG_SQL * 8),
            "segment_reduce_lanes": (
                lambda m: m.segment_reduce_lanes(w64, gid17, mask, NG_A, "sum"),
                lambda: seg.segment_reduce_lanes_plain(w64, gid17, mask, NG_A, "sum"),
                (gid17, w64, NG_A, torch.float64), 8, NG_A * 8),
        }
        key = f"n{n}_G{G}"
        out[key] = {}
        for name, (fn, plain, lib, vbytes, obytes) in specs.items():
            mod = seg if name == "segment_reduce_lanes" else gk
            bmod = bseg if name == "segment_reduce_lanes" else before
            nbytes = G * n + n * (4 + vbytes) + G * obytes
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = live * 2 / F32_OPS_PER_S * 1e3
            dev_ms, turns = in_turns(lambda: fn(mod), None if bmod is None else
                                     lambda: fn(bmod),
                                     lambda f: device_ms(f, launches=5))
            lib_ms, lib_calls = (None, 0) if lib is None or big else \
                lane_library_ms(mask, *lib)
            out[key][name] = {
                "ms": cuda_ms(lambda: fn(mod), 5), "device_ms": dev_ms,
                "plain_ms": None if big else cuda_ms(plain, 1),
                "library_ms": lib_ms, "library_calls": lib_calls,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "rows": n, "lanes": G}
            kind = {"filtered_group_sum_lanes": gk.KIND_SUM,
                    "fused_group_aggregate_lanes": gk.KIND_AGG}.get(name, gk.KIND_HIST)
            out[key][name]["lane_plan"] = (
                seg.lane_plan("sum", torch.float64, NG_A, G) if mod is seg else
                gk.lane_plan(kind, NG_SQL, G))._asdict()
            if turns is not None:
                out[key][name]["before"] = turns
            if name == "fused_group_aggregate_lanes":
                # the bytes a call allocates, and D-b's live share
                k2 = out[key][name]
                k2["alloc_bytes"] = alloc_bytes(lambda: fn(gk))
                if before is not None:
                    k2["before_alloc_bytes"] = alloc_bytes(lambda: fn(before))
                db = masks("D-b", n, G, codes, values, gen)
                db_live = lane_rows(db)
                db_bytes_ms = (G * n + n * 8 + G * NG_SQL * 20) / HBM_BYTES_PER_S * 1e3

                def k2_db(m):
                    return m.fused_group_aggregate_lanes(codes, values, db, NG_SQL)

                db_ms, db_turns = in_turns(lambda: k2_db(gk), None if before is None else
                                           lambda: k2_db(before),
                                           lambda f: device_ms(f, launches=5))
                k2["d_b"] = {"live_share": db_live / (G * n), "device_ms": db_ms,
                             "bound_ms": max(db_bytes_ms, db_live * 2 / F32_OPS_PER_S * 1e3)}
                if db_turns is not None:
                    k2["d_b"]["before"] = db_turns
                del db
            log(f"[phase12] (iv) {name} n={n} G={G}: {out[key][name]}")
        del codes, values, w64, mask, gid17, specs
        torch.cuda.empty_cache()
    return out


def phase12(gk, single, table, seed: int, before=None,
            observe: dict | None = None, refs: dict | None = None) -> tuple[dict, dict]:
    """Phase 12 over phase 3's session and its unchanged 100M rows
    (``streaming_scan = 0``): (iv) the lane-batched kernels, (i) the plan
    cache, (ii) PREPARE / EXECUTE, (iii) the dispatcher, (v) EXPLAIN
    ANALYZE; with ``before`` (the compared commit's group_kernels) its lane
    kernels are timed in turns with these, in (iv) and in (iii)'s profiled
    ticks.  -> (lane launches of (iii), measurements).  With ``observe``,
    phase 15 (iii) follows (iii) and leaves its launches and measurements
    there.  ``refs``: d_refs(table), when phase 18 (i) built them first."""
    t0 = time.perf_counter()
    out = {"kernels": lane_kernel_phase(gk, table.num_rows, seed, before)}
    torch.cuda.empty_cache()
    if refs is None:
        refs = d_refs(table)
    with flag(single, "streaming_scan", 0):
        out["cache"] = cache_phase(gk, single, refs)
        out["prepared"] = prepared_phase(single, refs)
        launches = {k: 0 for k in LANE_KERNELS}
        out["dispatch"] = dispatch_phase(gk, single, refs, seed, before)
        for name in D_SHAPES:
            for k, v in out["dispatch"][name]["lane_launches"].items():
                launches[k] += v
        if observe is not None:
            observe["iii_launches"], observe["iii_lanes"], observe["iii"] = \
                kill_dispatch_part(gk, single, refs, seed)
        out["explain"] = explain_phase(single, refs)
    out["seconds"] = time.perf_counter() - t0
    return launches, out


def cache_tpch_phase(s) -> dict:
    """Phase 12 (i), TPC-H: the host-bound queries at SF1, warm p50 with the
    plan cache on and with ``plan_cache_size = 0``; rows equal either way
    (``models/parity.py``)."""
    from baikaldb_tpu_torch.models import parity, tpch

    out = {}
    for q in CACHE_TPCH:
        sql = tpch.QUERIES[q]
        res, rows = {}, {}
        for mode, size in (("on", 256), ("off", 0)):
            with flag(s, "plan_cache_size", size):
                rows[mode] = s.query(sql)
                walls = []
                for _ in range(CACHE_TPCH_REPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s.query(sql)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t) * 1e3)
                res[mode] = statistics.median(walls)
        diff = parity.mismatch(rows["on"], rows["off"], sql)
        if diff is not None:
            raise AssertionError(f"{q}: rows with the plan cache differ: {diff}")
        out[q] = {"warm_ms_p50_on": res["on"], "warm_ms_p50_off": res["off"]}
    log(f"[phase12] (i) TPC-H host-bound queries, cache on / off: {out}")
    return out


# ----------------------------------------------------------------------
# phase 13: partitions, global indexes, MATCH and the session surface

PART_LO, PART_HI = 512, 1024          # (a-p)-(c-p)'s range of g
PART_BOUNDS = tuple(256 * (i + 1) for i in range(7))
TP_DDL = ("CREATE TABLE tp (g INT, v FLOAT, w DOUBLE, g16 INT) PARTITION BY RANGE (g) ("
          + ", ".join(f"PARTITION p{i} VALUES LESS THAN ({u})" for i, u in enumerate(PART_BOUNDS))
          + ", PARTITION p7 VALUES LESS THAN MAXVALUE)")
PART_QUERIES = {
    "a-p": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM {t} WHERE v*2+1 > 0.5 "
           f"AND g >= {PART_LO} AND g < {PART_HI} GROUP BY g16 ORDER BY g16",
    "b-p": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM {t} WHERE v*2+1 > 0.5 "
           f"AND g >= {PART_LO} AND g < {PART_HI} GROUP BY g ORDER BY g",
    "c-p": f"SELECT g, SUM(w), AVG(w) FROM {{t}} WHERE w > -1 AND g >= {PART_LO} "
           f"AND g < {PART_HI} GROUP BY g ORDER BY g",
}
GIDX_SELECTS = 100
GIDX_PAIRS = 100
MATCH_QUERIES = {
    "m-count": "SELECT COUNT(*) FROM orders WHERE MATCH(o_comment) AGAINST('special requests')",
    "m-top": "SELECT o_orderkey, MATCH(o_comment) AGAINST('+special -deposits' IN BOOLEAN "
             "MODE) AS s FROM orders ORDER BY s DESC, o_orderkey LIMIT 10",
}
MATCH_REPS = 10
SURFACE_ROWS = 250_000           # the round trip's rows: cut from 1,000,000 to keep the run in its limit
# the session surface: each statement's rows on the card equal the CPU's
SURFACE_STATEMENTS = (
    "SELECT @@version, @@session.autocommit, @@global.max_allowed_packet, @@version_comment",
    "SELECT @x, @never_set, DATABASE(), SCHEMA(), USER(), CURRENT_USER(), VERSION()",
    "SELECT @@tx_isolation, @@transaction_isolation",
    "SELECT id FROM su WHERE owner = USER() AND db = DATABASE() ORDER BY id",
    "SHOW COLLATION", "SHOW CHARSET", "SHOW ENGINES", "SHOW TABLE STATUS",
    "SHOW CREATE TABLE sp", "SHOW SESSION VARIABLES LIKE 'version'",
    "SELECT * FROM information_schema.tables",
    "SELECT * FROM information_schema.columns",
    "SELECT * FROM information_schema.views",
    "SELECT * FROM information_schema.partitions",
    "SELECT snapshot_ts > 0 AS pinned, query, holder FROM information_schema.snapshots",
    "SELECT COUNT(*) > 0 AS n FROM information_schema.trace_spans",
    "SELECT name, value, default_value FROM information_schema.flags",
    "SELECT name, spec, hits, trips FROM information_schema.failpoints",
    "SELECT * FROM information_schema.column_stats",
)


def partition_refs(table) -> dict:
    """numpy float64 references of (a-p)-(c-p) over ``table``'s rows, and of
    (b-p) after DROP PARTITION p2 (g in [512, 768) gone)."""
    g, v, w, g16 = (table.column(c).to_numpy() for c in ("g", "v", "w", "g16"))
    rng = (g >= PART_LO) & (g < PART_HI)
    keep_v = ((v * np.float32(2) + np.float32(1)).astype(np.float64) > 0.5) & rng
    keep_w = (w > -1) & rng
    p2 = (g >= PART_BOUNDS[1]) & (g < PART_BOUNDS[2])
    return {"a-p": reference(g16, v, keep_v, 16), "b-p": reference(g, v, keep_v, 2048),
            "c-p": reference(g, w, keep_w, 2048),
            "b-p dropped": reference(g, v, keep_v & ~p2, 2048),
            "kept_rows": int(((g >= PART_BOUNDS[1]) & (g < PART_BOUNDS[4])).sum()),
            "p2_rows": int(p2.sum())}


def pruned_kernel_checks(gk, batch) -> dict:
    """K1, K2, K3 and the segment kernel against their plain versions on the
    pruned batch itself (its codes, values and (a-p)-(c-p)'s masks), with
    phase 2's tolerances, then each timed there against its byte bound:
    ``ms`` (single event-timed calls), ``device_ms`` (20 back-to-back), the
    plain version and the library call where there is one."""
    col = dict(zip(batch.names, batch.columns))
    g, v, w = (col[c].data for c in ("g", "v", "w"))
    rng = (g >= PART_LO) & (g < PART_HI)
    return batch_kernel_checks(gk, batch, rng & ((v * 2 + 1).double() > 0.5),   # (a-p), (b-p)
                               rng & (w > -1), "[partitions]", "pruned")        # (c-p)


def batch_kernel_checks(gk, batch, where_v, where_w, tag: str, what: str,
                        ints: bool = False) -> dict:
    """K1-K3 at ``NG_SQL`` slots of g and the segment kernel at ``NG_A`` of
    g16 against their plain versions on ``batch``'s own columns under the
    masks ``where_v`` (over v) and ``where_w`` (over w), phase 2's
    tolerances; ``ints``: the segment kernel also over g as a view's integer
    SUM / MIN / MAX.  Then each timed there against its byte bound."""
    from baikaldb_tpu_torch.ops import segments as seg

    col = dict(zip(batch.names, batch.columns))
    g, g16, v, w = (col[c].data for c in ("g", "g16", "v", "w"))
    n = int(g.shape[0])
    k_err = max(check_case(gk, g, v, where_v, NG_SQL), check_case(gk, g, w.float(), where_w,
                                                                   NG_SQL))
    gid = torch.where(where_v, g16, NG_A)
    s_err = 0.0
    cases = [(where_v.to(torch.int64), "sum"), (where_v.to(torch.int32), "sum"),
             (v.double(), "sum"), (v, "sum"), (v, "min"), (v, "max")]
    if ints:
        cases += [(g.to(torch.int64), "sum"), (g, "min"), (g, "max")]
    for x, op in cases:
        s_err = max(s_err, seg_check(seg, x, gid, NG_A, op))
    live_v, live_w = int(where_v.sum()), int(where_w.sum())
    gid_v = torch.where(where_v, g, NG_SQL).long()
    gid_w = torch.where(where_w, g, NG_SQL).long()
    ones = torch.ones(n, dtype=torch.float32, device=g.device)
    acc32 = torch.zeros(NG_SQL + 1, dtype=torch.float32, device=g.device)
    acc64 = torch.zeros(NG_SQL + 1, dtype=torch.float64, device=g.device)
    accs = torch.zeros(NG_A + 1, dtype=torch.float64, device=g.device)
    v64, ids_a = v.double(), gid.long()
    specs = {
        # name: (call, plain call, library call or None, bytes, ops, ops/s)
        "filtered_group_sum": (lambda: gk.filtered_group_sum(g, w, where_w, NG_SQL),
                               lambda: gk.filtered_group_sum_plain(g, w, where_w, NG_SQL),
                               lambda: acc64.index_add_(0, gid_w, w),
                               n * 5 + live_w * 8 + NG_SQL * 8, live_w * 2, F32_OPS_PER_S),
        "fused_group_aggregate": (lambda: gk.fused_group_aggregate(g, v, where_v, NG_SQL),
                                  lambda: gk.fused_group_aggregate_plain(g, v, where_v, NG_SQL),
                                  None, n * 5 + live_v * 4 + NG_SQL * 16, live_v * 4,
                                  F32_OPS_PER_S),
        "partition_histogram": (lambda: gk.partition_histogram(g, where_v, NG_SQL),
                                lambda: gk.partition_histogram_plain(g, where_v, NG_SQL),
                                lambda: acc32.index_add_(0, gid_v, ones),
                                n * 5 + NG_SQL * 4, live_v, F32_OPS_PER_S),
        "segment_reduce": (lambda: seg.segment_reduce(v64, gid, NG_A, "sum"),
                           lambda: seg.segment_reduce_plain(v64, gid, NG_A, "sum"),
                           lambda: accs.index_add_(0, ids_a, v64),
                           n * (4 + 8) + NG_A * 8, live_v, F64_OPS_PER_S),
    }
    out = {"rows": n, "live_v": live_v, "live_w": live_w, "k_max_abs_err": k_err,
           "seg_max_abs_err": s_err, "kernels": {}}
    for name, (fn, plain, lib, nbytes, ops, rate) in specs.items():
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        out["kernels"][name] = {
            "ms": cuda_ms(fn, 20), "device_ms": device_ms(fn),
            "plain_ms": cuda_ms(plain, 3), "library_ms": None if lib is None else cuda_ms(lib, 3),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log(f"{tag} K1-K3 at {NG_SQL} slots and the segment kernel at {NG_A} on the {what} "
        f"batch ({n} rows) match the plain versions; "
        + ", ".join(f"{k} {t['device_ms']:.4f} device-ms (bound {t['bound_ms']:.4f})"
                    for k, t in out["kernels"].items()))
    return out


def partition_phase(gk, single, table) -> tuple[dict, dict]:
    """Phase 13 (i)-(v), in phase 3's session beside its unchanged ``t``:
    ``tp``, the same rows in 8 RANGE partitions of ``g``; (a-p)-(c-p)
    pruned to 3 of them (the closed-range rule keeps p2-p4), against numpy,
    the same SQL over ``t`` and their kernels' launches; the kernels against
    their plain versions on the pruned batch, timed there; DROP PARTITION
    p2 and (b-p) again.  -> (launches, measurements)."""
    from baikaldb_tpu_torch.models.parity import mismatch

    refs = partition_refs(table)
    torch.cuda.reset_peak_memory_stats()
    s = single
    store_t = s.db.stores["default.t"]
    stats: dict = {}
    with flag(s, "streaming_scan", 0):
        s.execute(TP_DDL)
        t0 = time.perf_counter()
        s.load_arrow("tp", table)
        stats["load_s"] = time.perf_counter() - t0
        store = s.db.stores["default.tp"]
        stats["regions"] = sum(1 for r in store.regions if r.num_rows)
        stats["partitions"] = sorted({r.part for r in store.regions if r.num_rows})
        log(f"[partitions] {table.num_rows} rows into 8 RANGE partitions of g in "
            f"{stats['load_s']:.2f} s: {stats['regions']} regions")
        # the partitioned path: counters at 0 just before, read just after
        reset_launches(gk)
        per_query = {}
        for q, sql in PART_QUERIES.items():
            qp = sql.format(t="tp")
            plan = s.execute("EXPLAIN " + qp).plan_text
            if "access=partition(5/8 partitions pruned)" not in plan:
                raise AssertionError(f"({q}) EXPLAIN lacks the reference's pruning: {plan}")
            before = all_launches(gk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = s.query(qp)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            got = {k: n - before[k] for k, n in all_launches(gk).items() if n != before[k]}
            base = q[0]
            if got != EXPECTED_LAUNCHES[base]:
                raise AssertionError(f"({q}) launched {got}, expected {EXPECTED_LAUNCHES[base]}")
            if base == "c":
                check_rows(q, rows, refs[q], has_count=False, has_min=False)
            else:
                check_rows(q, rows, refs[q])
            flat = s.query(sql.format(t="t"))
            diff = mismatch(rows, flat, qp, rtol=1e-6)
            if diff is not None:
                raise AssertionError(f"({q}) over tp differs from the same SQL over t: {diff}")
            per_query[q] = got
            st = stats[q] = {"first_ms": first_ms, "launches": got, "plan": plan,
                             **timed_query(s, qp, WARM_REPS)}
            if base == "a" and st["index_add_kernels"]:
                raise AssertionError(f"({q}) ran index_add_ on the card")
            st["over_t"] = timed_query(s, sql.format(t="t"), WARM_REPS)
            log(f"[partitions] ({q}) first {first_ms:.1f} ms (the first query stages the pruned "
                f"batch), warm "
                f"p50 {st['warm_ms_p50']:.3f} ms p67 {st['warm_ms_p67']:.3f} ms, device "
                f"{fmt(st['device_ms'], '.3f')} ms, idle {fmt(st['idle_share'], '.3f')}; "
                f"over t p50 "
                f"{st['over_t']['warm_ms_p50']:.3f} ms; launches {got}")
        launches = {k: sum(p.get(k, 0) for p in per_query.values()) for k in REPLACES}
        pruned = [b for k, (_, b) in s._access_batches.items()
                  if k[0] == "default.tp" and k[2] == "part"]
        if len(pruned) != 1 or len(pruned[0]) != refs["kept_rows"]:
            raise AssertionError(f"the pruned batch holds {[len(b) for b in pruned]} rows, "
                                 f"expected one of {refs['kept_rows']} (p2-p4)")
        stats["pruned_rows"] = refs["kept_rows"]
        stats["kernel_checks"] = pruned_kernel_checks(gk, pruned[0])
        del pruned
        t0 = time.perf_counter()
        n = s.execute("ALTER TABLE tp DROP PARTITION p2").affected_rows
        stats["drop_partition_s"] = time.perf_counter() - t0
        if n != refs["p2_rows"]:
            raise AssertionError(f"DROP PARTITION p2 removed {n} rows, expected "
                                 f"{refs['p2_rows']}")
        qp = PART_QUERIES["b-p"].format(t="tp")
        plan = s.execute("EXPLAIN " + qp).plan_text
        t0 = time.perf_counter()
        rows = s.query(qp)
        stats["after_drop_first_ms"] = (time.perf_counter() - t0) * 1e3
        check_rows("b-p dropped", rows, refs["b-p dropped"])
        stats["after_drop_plan"] = plan
        log(f"[partitions] DROP PARTITION p2 ({n} rows) in {stats['drop_partition_s']:.2f} s; "
            f"(b-p) after it equals numpy without p2's rows ({plan.splitlines()[-1].strip()})")
        s.execute("DROP TABLE tp")
        if store_t is not s.db.stores["default.t"]:
            raise AssertionError("phase 13 replaced t's store")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return launches, stats


def global_index_phase(seed: int) -> dict:
    """Phase 13 (vi): sysbench's 1M-row table twice on the card, ``sbtest1``
    with its KEY k_1 and ``sbg`` with k_1 as a GLOBAL INDEX, from the same
    generator and seed; point selects ``WHERE k = ?`` through
    ``global_index(k_1:k)`` equal to the same statements over sbtest1; then
    UPDATE-k / DELETE / INSERT on both, after which sbg's backing table
    equals its (k, id) projection and the selects still agree."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import sysbench as sb

    s = Session(device="cuda")
    s.execute(sb.DDL)
    s.execute(sb.DDL.replace("sbtest1", "sbg").replace("KEY k_1 (k)", "GLOBAL INDEX k_1 (k)"))
    for name in ("sbtest1", "sbg"):
        s.db.stores[f"default.{name}"].region_rows = SB_REGION_ROWS
    table = sb.table(SB_ROWS, seed)
    s.load_arrow("sbtest1", table)
    t0 = time.perf_counter()
    s.load_arrow("sbg", table)
    stats = {"rows": SB_ROWS, "load_s": time.perf_counter() - t0}
    rng = np.random.default_rng(seed + 17)
    ks = table.column("k").to_numpy()
    plan = s.execute("EXPLAIN SELECT id, k, c, pad FROM sbg WHERE k = 5").plan_text
    if "access=global_index(k_1:k)" not in plan:
        raise AssertionError(f"the point select does not read through the global index: {plan}")
    times: dict = {"select": [], "update": [], "delete": [], "insert": []}

    def timed(kind, sql):
        t = time.perf_counter()
        out = s.execute(sql)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t) * 1e3)
        return out

    def selects(keys, kind):
        for k in keys:
            sql = "SELECT id, k, c, pad FROM {t} WHERE k = " + str(int(k)) + " ORDER BY id"
            got = timed(kind, sql.format(t="sbg")).to_pylist() if kind else \
                s.query(sql.format(t="sbg"))
            want = s.query(sql.format(t="sbtest1"))
            if got != want or not got:
                raise AssertionError(f"k = {k}: sbg gives {got}, sbtest1 {want}")
    selects(rng.choice(ks, GIDX_SELECTS), "select")
    ids = rng.choice(np.arange(1, SB_ROWS + 1), 2 * GIDX_PAIRS, replace=False)
    for up, de in zip(ids[:GIDX_PAIRS], ids[GIDX_PAIRS:]):
        for t, kind in (("sbg", True), ("sbtest1", False)):
            stmts = (("update", f"UPDATE {t} SET k = k + 1 WHERE id = {int(up)}"),
                     ("delete", f"DELETE FROM {t} WHERE id = {int(de)}"),
                     ("insert", f"INSERT INTO {t} VALUES ({int(de)}, {int(up) % SB_ROWS + 1}, "
                                f"'c{int(de)}', 'p{int(de)}')"))
            for k, sql in stmts:
                r = timed(k, sql) if kind else s.execute(sql)
                if r.affected_rows != 1:
                    raise AssertionError(f"{sql}: {r.affected_rows} rows")
    main = s.execute("SELECT k, id FROM sbg").arrow
    back = s.execute("SELECT k, id FROM `__gidx__sbg__k_1`").arrow
    pairs = [np.lexsort((t.column("id").to_numpy(), t.column("k").to_numpy())) for t in (main, back)]
    for c in ("k", "id"):
        if not np.array_equal(main.column(c).to_numpy()[pairs[0]],
                              back.column(c).to_numpy()[pairs[1]]):
            raise AssertionError("the backing table differs from sbg's (k, id) projection")
    selects(np.concatenate([rng.choice(ks, 10), [int(u) % SB_ROWS + 1 for u in ids[:10]]]), None)
    stats["per_kind"] = {k: percentiles(v) for k, v in times.items()}
    stats["plan"] = plan
    log(f"[global index] {GIDX_SELECTS} point selects through global_index(k_1:k) equal "
        f"sbtest1's; {GIDX_PAIRS} UPDATE-k / DELETE / INSERT pairs keep the backing table equal "
        f"to (k, id); p50 / p99 ms "
        + ", ".join(f"{k} {v['p50_ms']:.2f} / {v['p99_ms']:.2f}"
                    for k, v in stats["per_kind"].items()))
    s.execute("DROP TABLE sbg")
    s.execute("DROP TABLE sbtest1")
    return stats


def match_phase(s, tables: dict) -> dict:
    """Phase 13 (vii): MATCH ... AGAINST over phase 5 (ii)'s ``orders`` on
    the card (the inverted index builds at the first query), each query's
    rows equal a CPU session's over the same rows (relevance within 1e-6
    relative); first and warm p50 ms."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.models.parity import mismatch

    cpu = Session(device="cpu")
    cpu.execute(tpch.DDL["orders"])
    cpu.load_arrow("orders", tables["orders"])
    stats = {"orders": tables["orders"].num_rows}
    for name, sql in MATCH_QUERIES.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = s.query(sql)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        diff = mismatch(rows, cpu.query(sql), sql, rtol=1e-6)
        if diff is not None or not rows:
            raise AssertionError(f"{name}: the card differs from the CPU ({diff}): {sql}")
        walls = []
        for _ in range(MATCH_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.query(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        stats[name] = {"first_ms": first, "warm_ms_p50": statistics.median(walls),
                       "rows": rows if name == "m-count" else len(rows)}
        log(f"[match] {name}: first {first:.1f} ms, warm p50 {stats[name]['warm_ms_p50']:.2f} "
            f"ms, equal to the CPU's rows")
    return stats


def surface_phase() -> dict:
    """Phase 13 (viii): the session surface through a CUDA and a CPU
    ``Session``, every statement's rows equal: the connection environment,
    the SHOW forms, the ``information_schema`` tables, HANDLE set_flag, and
    a LOAD DATA round trip of SURFACE_ROWS rows through SELECT ... INTO
    OUTFILE."""
    import tempfile

    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models.parity import mismatch

    rng = np.random.default_rng(23)
    data = pa.table({"id": np.arange(SURFACE_ROWS, dtype=np.int64),
                     "g": rng.integers(0, 1000, SURFACE_ROWS, dtype=np.int32),
                     "v": rng.standard_normal(SURFACE_ROWS)})
    sessions = {"card": Session(device="cuda"), "cpu": Session(device="cpu")}
    stats: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, s in sessions.items():
            for q in ("SET @x = 7", "SET SESSION TRANSACTION ISOLATION LEVEL READ COMMITTED",
                      "CREATE TABLE su (id BIGINT PRIMARY KEY, owner VARCHAR(32), "
                      "db VARCHAR(16))",
                      "INSERT INTO su VALUES (1, 'root@localhost', 'default'), "
                      "(2, 'other', 'x')",
                      "CREATE TABLE sp (id BIGINT PRIMARY KEY, g INT, v DOUBLE) "
                      "PARTITION BY HASH (g) PARTITIONS 4",
                      "CREATE TABLE sl (id BIGINT PRIMARY KEY, g INT, v DOUBLE)",
                      "CREATE VIEW sv AS SELECT id, g FROM sp WHERE g < 10",
                      "HANDLE set_flag plan_cache_size 256"):
                s.execute(q)
            s.load_arrow("sp", data)
            t0 = time.perf_counter()
            path = os.path.join(tmp, f"{name}.csv")
            n_out = s.execute(f"SELECT id, g, v FROM sp ORDER BY id INTO OUTFILE '{path}'"
                              ).affected_rows
            t1 = time.perf_counter()
            n_in = s.execute(f"LOAD DATA INFILE '{path}' INTO TABLE sl").affected_rows
            t2 = time.perf_counter()
            if n_out != SURFACE_ROWS or n_in != SURFACE_ROWS:
                raise AssertionError(f"{name}: OUTFILE {n_out} rows, LOAD DATA {n_in} rows")
            stats[name] = {"outfile_s": t1 - t0, "load_data_s": t2 - t1}
        if open(os.path.join(tmp, "card.csv")).read() != open(os.path.join(tmp, "cpu.csv")).read():
            raise AssertionError("INTO OUTFILE: the card's file differs from the CPU's")
    card, cpu = sessions["card"], sessions["cpu"]
    for s in sessions.values():
        s.execute("SET SNAPSHOT = 'now'")          # a pin for information_schema.snapshots
    checks = SURFACE_STATEMENTS + (
        "SELECT g, COUNT(*) n, SUM(v) s FROM sl GROUP BY g ORDER BY g",
        "SELECT COUNT(*) n FROM sl WHERE v > 1", "SELECT id, g, v FROM sl WHERE id = 4242")
    for sql in checks:
        got, want = card.query(sql), cpu.query(sql)
        if not sql.startswith("SELECT"):
            diff = None if got == want else f"{got} != {want}"
        else:
            # 1,000 groups: the card's segment kernel against the CPU's K1
            # (float32 sums) under the contract's 1e-4
            diff = mismatch(got, want, sql, rtol=1e-4 if "GROUP BY" in sql else 1e-9)
        if diff is not None:
            raise AssertionError(f"surface: the card differs from the CPU ({diff}): {sql}")
    for s in sessions.values():
        s.execute("SET SNAPSHOT = 0")
    stats["statements"] = len(checks)
    log(f"[surface] {len(checks)} statements equal on the card and the CPU; OUTFILE / LOAD DATA "
        f"of {SURFACE_ROWS} rows {stats['card']['outfile_s']:.2f} / "
        f"{stats['card']['load_data_s']:.2f} s on the card")
    return stats


# ----------------------------------------------------------------------
# phase 14: rollups, a materialized view and change capture over the 100M
# rows; online ADD INDEX over sysbench's 1M; TTL over 10M

# r_g keeps FLOAT measures only: a DOUBLE MIN / MAX in a refresh fails the
# group kernels' gate (ops/hashagg.dense_kernel_cols, the JAX package's
# too), and the whole refresh then scatters; r_gw shows that path
ROLLUPS = {"r_g": "(g, AGGREGATE(v))", "r_g16": "(g16, AGGREGATE(v))",
           "r_gw": "(g, AGGREGATE(w))"}
ROLLUP_QUERIES = {
    "r_g": "SELECT g, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t GROUP BY g ORDER BY g",
    "r_g16": "SELECT g16, COUNT(*), SUM(v), AVG(v), MIN(v) FROM t GROUP BY g16 ORDER BY g16",
    "r_gw": "SELECT g, SUM(w), AVG(w), MIN(w) FROM t GROUP BY g ORDER BY g",
}
LC_INSERT_ROWS = 1000             # the write after which the rollups refresh
LC_ROUND_ROWS = 500               # the view's insert round
ROLLUP_TURNS = 3                  # no-rollup and rollup answers timed in alternating turns
MV_SQL = "SELECT g16, COUNT(*), SUM(g), MIN(g), MAX(g) FROM t GROUP BY g16"
MV_QUERY = MV_SQL + " ORDER BY g16"
# the view's write rounds (name, event, SQL, rows): each touches at most
# 1,000 rows (row images) but the last; round "min" moves rows off g = 0,
# group g16 = 5's MIN, so the UPDATE's row pairs retract that MIN (one group
# rescan); the bulk delete's ~49,000 rows log a statement image (a re-seed)
MV_ROUNDS = [("insert", "insert", None, None),
             ("delete", "delete", "DELETE FROM t WHERE g = 3 AND v > 3",
              lambda c: (c["g"] == 3) & (c["v"] > np.float32(3))),
             ("update", "update", "UPDATE t SET g = g + 1 WHERE g = 9 AND v > 3",
              lambda c: (c["g"] == 9) & (c["v"] > np.float32(3))),
             ("min", "update", "UPDATE t SET g = g + 1 WHERE g = 0 AND g16 = 5 AND v > 2.5",
              lambda c: (c["g"] == 0) & (c["g16"] == 5) & (c["v"] > np.float32(2.5))),
             ("bulk", "delete", "DELETE FROM t WHERE g = 11", lambda c: c["g"] == 11)]
# each round's (group rescans, re-seeds): the folds none, "min" one rescan
# of its group, "bulk" one re-seed
MV_REFOLDS = {"insert": (0, 0), "delete": (0, 0), "update": (0, 0), "min": (1, 0),
              "bulk": (0, 1)}
# the kernels the refreshes and the view's seed launch (EXPLAIN and the
# counters: r_g's refresh K3 + K2, r_g16's and the seed the segment kernel)
LIFECYCLE_KERNELS = ("fused_group_aggregate", "partition_histogram", "segment_reduce")
# a change-stream consumer: sysbench oltp_write_only transactions over the
# 1M rows, read back by FETCH batches of 100 and of 500
LC_CDC_TXNS = 125                 # 500 events: one full FETCH 500 (~50 ms a write with row capture;
                                  # 300 until PR 14, 250 and FETCH 1000 until PR 17)
LC_CDC_BATCHES = (100, 500)
SB_WRITES = {"index_update": "update", "non_index_update": "update", "delete": "delete",
             "insert": "insert"}
LC_DDL_UPDATES = 400              # the second session's point UPDATEs of k, at most
LC_TTL_ROWS = 10_000_000
LC_TTL_EXPIRED = 0.3


class HostRows:
    """Phase 14's numpy state of ``t``: the columns, the view's references
    from a (g16, g) histogram, and each write applied the way the SQL does
    it (-> the rows it touched, for the change events)."""

    def __init__(self, cols: dict):
        self.cols = cols
        self.hist = self._hist(cols)
        self.refs: dict = {}        # the rollups' references, kept across inserts

    @staticmethod
    def _hist(cols) -> np.ndarray:
        return np.bincount(cols["g16"].astype(np.int64) * 2048 + cols["g"],
                           minlength=16 * 2048).reshape(16, 2048)

    def rows(self, mask) -> list:
        return sorted(zip(*(self.cols[c][mask].tolist() for c in ("g", "v", "w", "g16"))))

    def insert(self, new: dict) -> None:
        self.cols = {c: np.concatenate([self.cols[c], new[c]]) for c in self.cols}
        self.hist += self._hist(new)
        for name, ref in self.refs.items():
            add = self._group_ref(name, new)
            self.refs[name] = (ref[0] + add[0], ref[1] + add[1], ref[2] + add[2],
                               np.minimum(ref[3], add[3]))

    def delete(self, mask) -> None:
        self.refs = {}
        self.hist -= self._hist({c: a[mask] for c, a in self.cols.items()})
        self.cols = {c: a[~mask] for c, a in self.cols.items()}

    def update_g(self, mask) -> None:
        self.refs = {}
        self.hist -= self._hist({c: a[mask] for c, a in self.cols.items()})
        self.cols["g"] = np.where(mask, self.cols["g"] + 1, self.cols["g"]).astype(np.int32)
        self.hist += self._hist({c: a[mask] for c, a in self.cols.items()})

    def view_rows(self) -> list:
        """MV_QUERY's rows: exact integers."""
        gs = np.arange(2048)
        out = []
        for k in range(16):
            h = self.hist[k]
            nz = np.nonzero(h)[0]
            if len(nz):
                out.append({"g16": k, "count_star()": int(h.sum()), "sum(g)": int(h @ gs),
                            "min(g)": int(nz[0]), "max(g)": int(nz[-1])})
        return out

    def rollup_ref(self, name: str):
        """``reference()``'s (counts, sums, sum|x|, mins) of rollup ``name``'s
        query over the rows."""
        if name not in self.refs:
            self.refs[name] = self._group_ref(name, self.cols)
        return self.refs[name]

    @staticmethod
    def _group_ref(name: str, c: dict):
        key, val, ng = {"r_g": ("g", "v", 2048), "r_g16": ("g16", "v", 16),
                        "r_gw": ("g", "w", 2048)}[name]
        k, x = c[key], c[val].astype(np.float64)
        counts = np.bincount(k, minlength=ng)
        mins = np.full(ng, np.inf)
        np.minimum.at(mins, k, x)
        return (counts, np.bincount(k, weights=x, minlength=ng),
                np.bincount(k, weights=np.abs(x), minlength=ng), mins)


def lifecycle_rows(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, 2048, n, dtype=np.int32),
            "v": rng.standard_normal(n, dtype=np.float32),
            "w": rng.standard_normal(n),
            "g16": rng.integers(0, 16, n, dtype=np.int32)}


def insert_sql(rows: dict) -> str:
    return "INSERT INTO t VALUES " + ",".join(
        f"({int(g)}, {float(v)!r}, {float(w)!r}, {int(k)})"
        for g, v, w, k in zip(rows["g"], rows["v"], rows["w"], rows["g16"]))


def timed_first(gk, s, sql: str):
    """One run, timed, with the kernel launches it made -> (rows, ms, launches)."""
    before = all_launches(gk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = s.query(sql)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return rows, ms, {k: n - before[k] for k, n in all_launches(gk).items() if n != before[k]}


def warm_walls(s, sql: str, reps: int) -> list:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.query(sql)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return walls


def warm_stats(walls: list, turns: list) -> dict:
    """p50 / p67 of all the runs, and each turn's p50 (the spread)."""
    return {"warm_ms_p50": statistics.median(walls),
            "warm_ms_p67": float(np.percentile(walls, 67)), "turn_p50_ms": turns}


def check_rollup(name: str, rows, host: HostRows) -> None:
    check_rows(name, rows, host.rollup_ref(name), has_count=name != "r_gw")


def rollup_part(gk, s, host: HostRows, seed: int) -> tuple[dict, dict]:
    """(i): the three rollups over ``t``.  Each query is timed with no rollup
    and from its rollup in alternating turns (ADD ROLLUP before each rollup
    turn, DROP ROLLUP after it); -> (launches by statement, stats)."""
    reps = WARM_REPS // ROLLUP_TURNS
    walls = {(n, side): ([], []) for n in ROLLUPS for side in ("base", "rollup")}
    stats: dict = {n: {"refresh_first_ms": [], "launches": []} for n in ROLLUPS}
    launches: dict = {}

    def timed(name, side, sql):
        w = warm_walls(s, sql, reps)
        walls[name, side][0].extend(w)
        walls[name, side][1].append(statistics.median(w))

    for turn in range(ROLLUP_TURNS):
        for name, sql in ROLLUP_QUERIES.items():
            s.query(sql)                # the plan after the DROP, untimed
            timed(name, "base", sql)
        for name, cols in ROLLUPS.items():
            s.execute(f"ALTER TABLE t ADD ROLLUP {name} {cols}")
        for name, sql in ROLLUP_QUERIES.items():
            rows, first_ms, got = timed_first(gk, s, sql)
            check_rollup(name, rows, host)
            plan = s.execute("EXPLAIN " + sql).plan_text
            if f"__rollup_t_{name}" not in plan:
                raise AssertionError(f"{name}: EXPLAIN does not name its rollup table: {plan}")
            launches[f"refresh_{name}_{turn}"] = got
            stats[name]["refresh_first_ms"].append(first_ms)
            stats[name]["launches"].append(got)
            stats[name]["plan"] = plan
            timed(name, "rollup", sql)
        if turn < ROLLUP_TURNS - 1:
            for name in ROLLUPS:
                s.execute(f"ALTER TABLE t DROP ROLLUP {name}")
    stats["no_rollup"] = {n: warm_stats(*walls[n, "base"]) for n in ROLLUPS}
    for name in ROLLUPS:
        st = stats[name]
        st.update(warm_stats(*walls[name, "rollup"]))
        base = stats["no_rollup"][name]
        log(f"[lifecycle] rollup {name}: first answer (its refresh over {len(host.cols['g'])} "
            f"rows) {', '.join(f'{x:.1f}' for x in st['refresh_first_ms'])} ms in "
            f"{ROLLUP_TURNS} turns, launches {st['launches'][0]}; warm p50 "
            f"{st['warm_ms_p50']:.3f} ms p67 {st['warm_ms_p67']:.3f} ms (turns "
            f"{', '.join(f'{x:.3f}' for x in st['turn_p50_ms'])}) against "
            f"{base['warm_ms_p50']:.3f} ms p67 {base['warm_ms_p67']:.3f} ms with no rollup "
            f"(turns {', '.join(f'{x:.3f}' for x in base['turn_p50_ms'])})")
    new = lifecycle_rows(LC_INSERT_ROWS, seed + 141)
    t0 = time.perf_counter()
    s.execute(insert_sql(new))
    stats["insert_s"] = time.perf_counter() - t0
    host.insert(new)
    for name, sql in ROLLUP_QUERIES.items():
        rows, ms, got = timed_first(gk, s, sql)
        check_rollup(name, rows, host)
        launches[f"refresh_after_insert_{name}"] = got
        stats[name]["refresh_after_insert_ms"] = ms
        stats[name]["launches_after_insert"] = got
    log(f"[lifecycle] INSERT of {LC_INSERT_ROWS} rows {stats['insert_s']:.2f} s; the next "
        "answers refresh in " + ", ".join(f"{n} {stats[n]['refresh_after_insert_ms']:.1f} ms"
                                          for n in ROLLUPS) + "; all equal numpy")
    return launches, stats


def call_counter(obj, *names: str) -> dict:
    """Count the calls of ``obj``'s methods ``names`` (wrapped on the
    instance) -> the live counts."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _fn=getattr(obj, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        setattr(obj, name, counted)
    return calls


def view_part(gk, s, host: HostRows, seed: int) -> tuple[dict, dict, list]:
    """(ii): the materialized view over ``t`` and its write rounds; -> (launches
    by statement, stats, the events the rounds must have logged).  Each
    round's group rescans and re-seeds are counted on the view itself, so a
    re-seed cannot pass for a group rescan."""
    stats: dict = {"rounds": {}}
    launches: dict = {}
    s.execute(f"CREATE MATERIALIZED VIEW mv AS {MV_SQL}")
    calls = call_counter(s.db.matviews.get("default", "mv"), "_rescan_group", "_rebuild")
    rows, ms, got = timed_first(gk, s, MV_QUERY)
    launches["seed"] = got
    stats["seed_ms"], stats["seed_launches"] = ms, got

    def check(step):
        want = host.view_rows()
        if rows != want:
            raise AssertionError(f"view after {step}: {rows} != numpy {want}")
        if view_and_recompute(s, MV_QUERY) != rows:
            raise AssertionError(f"view after {step} answered differently a second time")

    def rescans():
        return s.query("SELECT rescans FROM information_schema.materialized_views")[0]["rescans"]

    check("its seed")
    log(f"[lifecycle] view seed over {len(host.cols['g'])} rows {ms:.1f} ms, launches {got}")
    events = []
    for name, kind, sql, where in MV_ROUNDS:
        if kind == "insert":
            new = lifecycle_rows(LC_ROUND_ROWS, seed + 142)
            sql = insert_sql(new)
            images = sorted(zip(*(new[c].tolist() for c in ("g", "v", "w", "g16"))))
            want_n = len(images)
        else:
            m = where(host.cols)
            want_n = int(m.sum())
            images = host.rows(m) if want_n <= 1000 else []
        before = (calls["_rescan_group"], calls["_rebuild"], rescans())
        t0 = time.perf_counter()
        n = s.execute(sql).affected_rows
        write_s = time.perf_counter() - t0
        if n != want_n:
            raise AssertionError(f"round {name}: {n} rows, numpy {want_n}")
        if kind == "insert":
            host.insert(new)
        elif kind == "update":
            host.update_g(m)
            images = (images, host.rows(m))
        else:
            host.delete(m)
        events.append((kind, n, images))
        rows, ms, got = timed_first(gk, s, MV_QUERY)
        refolds = (calls["_rescan_group"] - before[0], calls["_rebuild"] - before[1])
        if refolds != MV_REFOLDS[name] or rescans() - before[2] != sum(refolds):
            raise AssertionError(f"round {name}: (group rescans, re-seeds) {refolds}, "
                                 f"rescans +{rescans() - before[2]}, want {MV_REFOLDS[name]}")
        check(name)
        launches[f"round_{name}"] = got
        stats["rounds"][name] = {"rows": n, "write_s": write_s, "answer_ms": ms,
                                 "group_rescans": refolds[0], "reseeds": refolds[1],
                                 "launches": got}
        log(f"[lifecycle] view round {name}: {n} rows written in {write_s:.2f} s, the "
            f"answer (fold + {refolds[0]} group rescans + {refolds[1]} re-seeds + answer) "
            f"{ms:.1f} ms, launches {got}; equal to numpy and the recompute")
    info = s.query("SELECT staleness_ms, deltas_folded, rescans, groups FROM "
                   "information_schema.materialized_views")[0]
    stats.update(info)
    return launches, stats, events


def cdc_check(s, events: list) -> dict:
    """(iii): FETCH the subscription over ``t``; each event's kind, affected
    count and row images equal the statements run."""
    import json as _json

    got = s.query("FETCH 1000 FROM feed")
    if len(got) != len(events) or s.query("FETCH 1000 FROM feed"):
        raise AssertionError(f"FETCH gave {len(got)} events, the statements {len(events)}")
    for e, (kind, n, images) in zip(got, events):
        if (e["event_type"], e["affected"], e["table_name"]) != (kind, n, "default.t"):
            raise AssertionError(f"event {e['event_type']} {e['affected']} != {kind} {n}")
        imgs = _json.loads(e["rows"])
        key = ("g", "v", "w", "g16")
        if kind == "update":
            old = sorted(tuple(r["old"][c] for c in key) for r in imgs)
            new = sorted(tuple(r["new"][c] for c in key) for r in imgs)
            if (old, new) != (images[0], images[1]):
                raise AssertionError("update event's row images differ from numpy")
        elif sorted(tuple(r[c] for c in key) for r in imgs) != images:
            raise AssertionError(f"{kind} event's row images differ from numpy")
        if not images and not e["statement"]:
            raise AssertionError(f"{kind} event carries neither rows nor a statement")
    return {"events": len(got)}


def check_sb_event(e: dict, kind: str, args: tuple) -> None:
    """One FETCH row against the sysbench write that logged it."""
    import json as _json

    rows = _json.loads(e["rows"])
    ok = (e["event_type"], e["affected"], e["table_name"], len(rows)) == \
        (SB_WRITES[kind], 1, "default.sbtest1", 1)
    if ok and kind == "insert":
        ok = rows[0] == dict(zip(("id", "k", "c", "pad"), args))
    elif ok and kind == "delete":
        ok = rows[0]["id"] == args[0]
    elif ok:
        old, new = rows[0]["old"], rows[0]["new"]
        ok = old["id"] == new["id"] == args[0] and (
            new["k"] == old["k"] + 1 if kind == "index_update"
            else (new["c"], new["k"]) == (args[1], old["k"]))
    if not ok:
        raise AssertionError(f"the event of sysbench {kind} {args}: {e}")


def cdc_stream_part(s, seed: int) -> dict:
    """(iii) at a consumer's scale: sysbench oltp_write_only transactions
    over sbtest1's 1M rows (one event a statement, its row images), read by
    one subscription in FETCH batches of 100 and by another in batches of
    500, each until empty; every event against the statement that logged
    it.  -> per batch size, the calls' p50 / p99 ms and events/s."""
    from baikaldb_tpu_torch.models import sysbench as sb

    for b in LC_CDC_BATCHES:
        s.execute(f"CREATE SUBSCRIPTION f{b} ON sbtest1")
    wl = sb.Workload(SB_ROWS, seed + 145)
    writes, walls = [], {k: [] for k in SB_WRITES}
    t0 = time.perf_counter()
    for _ in range(LC_CDC_TXNS):
        s.execute("BEGIN")
        for kind, sql, args in wl.transaction():
            if kind in SB_WRITES:
                t = time.perf_counter()
                if s.execute(sql).affected_rows != 1:
                    raise AssertionError(f"sysbench {kind} missed its row: {sql}")
                walls[kind].append((time.perf_counter() - t) * 1e3)
                writes.append((kind, args))
        s.execute("COMMIT")
    stats: dict = {"transactions": LC_CDC_TXNS, "events": len(writes),
                   "write_s": time.perf_counter() - t0,
                   "write_ms": {k: percentiles(w) for k, w in walls.items()}}
    for b in LC_CDC_BATCHES:
        walls, full, got = [], [], []
        while True:
            t = time.perf_counter()
            rows = s.query(f"FETCH {b} FROM f{b}")
            walls.append((time.perf_counter() - t) * 1e3)
            if len(rows) == b:
                full.append(walls[-1])
            if not rows:
                break
            got += rows
        if len(got) != len(writes):
            raise AssertionError(f"FETCH {b}: {len(got)} events, {len(writes)} statements")
        for e, (kind, args) in zip(got, writes):
            check_sb_event(e, kind, args)
        stats[f"fetch_{b}"] = {**percentiles(walls), "calls": len(walls),
                               "full_batch_p50_ms": statistics.median(full),
                               "events_per_s": len(got) / (sum(walls) / 1e3)}
        s.execute(f"DROP SUBSCRIPTION f{b}")
    log(f"[lifecycle] change stream: {LC_CDC_TXNS} oltp_write_only transactions over "
        f"{SB_ROWS} rows in {stats['write_s']:.2f} s (write p50 ms " + ", ".join(
            f"{k} {w['p50_ms']:.1f}" for k, w in stats["write_ms"].items()) +
        f"), {len(writes)} events equal the statements; " + "; ".join(
            f"FETCH {b}: {st['calls']} calls p50 {st['p50_ms']:.2f} ms p99 {st['p99_ms']:.2f} ms "
            f"(a full batch p50 {st['full_batch_p50_ms']:.2f}), {st['events_per_s']:.0f} events/s"
            for b in LC_CDC_BATCHES for st in [stats[f"fetch_{b}"]]))
    return stats


def online_ddl_part(seed: int) -> tuple[dict, object]:
    """(iv): ADD INDEX k_1 over sysbench's 1M rows while a second session
    updates k by primary key, then ADD GLOBAL INDEX gk (k), dropped after
    its point selects; -> (stats, the session over sbtest1)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.models import sysbench as sb

    s = Session(device="cuda")
    s.execute(sb.DDL.replace(", KEY k_1 (k)", ""))
    table = sb.table(SB_ROWS, seed)
    s.load_arrow("sbtest1", table)
    k = table.column("k").to_numpy().copy()        # k of id i at k[i - 1]
    del table
    probe = int(k[12345])
    q = f"SELECT id FROM sbtest1 WHERE k = {probe} ORDER BY id"
    stats = {"rows": SB_ROWS, "plan_before": s.execute("EXPLAIN " + q).plan_text}
    if "access=full" not in stats["plan_before"]:
        raise AssertionError(f"before ADD INDEX: {stats['plan_before']}")
    rng = np.random.default_rng(seed + 143)
    ids = rng.integers(1, SB_ROWS + 1, LC_DDL_UPDATES)
    done = threading.Event()
    applied: list = []
    errors: list = []

    def updater():
        other = Session(s.db)
        try:
            for i in ids:
                if done.is_set():
                    break
                if other.execute(f"UPDATE sbtest1 SET k = k + 1 WHERE id = {int(i)}"
                                 ).affected_rows != 1:
                    raise AssertionError(f"UPDATE of id {i} missed its row")
                applied.append(int(i))
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    th = threading.Thread(target=updater)
    th.start()
    t0 = time.perf_counter()
    wid = s.query("ALTER TABLE sbtest1 ADD INDEX k_1 (k)")[0]["work_id"]
    w = s.db.ddl.wait(wid, 600.0)
    stats["publish_s"] = time.perf_counter() - t0
    done.set()
    th.join(600)
    if errors or th.is_alive():
        raise AssertionError(f"the updating session failed: {errors}")
    if w.state != "public":
        raise AssertionError(f"ADD INDEX ended {w.state}: {w.error}")
    for i in applied:
        k[i - 1] += 1
    stats["updates_during"] = len(applied)
    stats["plan_after"] = s.execute("EXPLAIN " + q).plan_text
    if "access=index(k_1:k)" not in stats["plan_after"]:
        raise AssertionError(f"after ADD INDEX: {stats['plan_after']}")
    got = s.execute("SELECT id, k FROM sbtest1").arrow
    order = np.argsort(got.column("id").to_numpy())
    if not np.array_equal(got.column("k").to_numpy()[order], k):
        raise AssertionError("k after the online ADD INDEX differs from the replay")
    want = [{"id": int(i) + 1} for i in np.nonzero(k == probe)[0]]
    if s.query(q) != want:
        raise AssertionError("the point select through k_1 differs from the replay")
    log(f"[lifecycle] ADD INDEX k_1 over {SB_ROWS} rows published in {stats['publish_s']:.3f} s "
        f"with {len(applied)} point UPDATEs of k from a second session; rows equal the replay")
    s.execute("ALTER TABLE sbtest1 DROP INDEX k_1")
    t0 = time.perf_counter()
    wid = s.query("ALTER TABLE sbtest1 ADD GLOBAL INDEX gk (k)")[0]["work_id"]
    w = s.db.ddl.wait(wid, 600.0)
    stats["global_backfill_s"] = time.perf_counter() - t0
    if w.state != "public":
        raise AssertionError(f"ADD GLOBAL INDEX ended {w.state}: {w.error}")
    stats["plan_global"] = s.execute("EXPLAIN " + q).plan_text
    if "access=global_index(gk:k)" not in stats["plan_global"]:
        raise AssertionError(f"after ADD GLOBAL INDEX: {stats['plan_global']}")
    walls = []
    for kv in rng.choice(k, GIDX_SELECTS):
        sql = f"SELECT id FROM sbtest1 WHERE k = {int(kv)} ORDER BY id"
        t0 = time.perf_counter()
        rows = s.query(sql)
        walls.append((time.perf_counter() - t0) * 1e3)
        if rows != [{"id": int(i) + 1} for i in np.nonzero(k == kv)[0]]:
            raise AssertionError(f"k = {kv} through gk differs from the replay")
    stats["global_select"] = percentiles(walls)
    log(f"[lifecycle] ADD GLOBAL INDEX gk backfilled in {stats['global_backfill_s']:.3f} s; "
        f"point selects through it p50 {stats['global_select']['p50_ms']:.2f} ms")
    # the coupled global-index path captures no row images (as in the JAX
    # session): the change stream after it runs without gk
    s.execute("ALTER TABLE sbtest1 DROP INDEX gk")
    return stats, s


def ttl_part(seed: int) -> dict:
    """(v): ``ev`` with TTL=3600 on ts, 10M rows, 30% of them past it."""
    import datetime

    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Session

    rng = np.random.default_rng(seed + 144)
    n = LC_TTL_ROWS
    now = datetime.datetime.now()
    expired = rng.random(n) < LC_TTL_EXPIRED
    age_s = np.where(expired, 7200, rng.integers(0, 3000, n))
    ts = np.datetime64(now, "us") - age_s.astype("timedelta64[s]")
    v = rng.integers(0, 1000, n, dtype=np.int32)
    s = Session(device="cuda")
    s.execute("CREATE TABLE ev (id BIGINT PRIMARY KEY, ts DATETIME, v INT) TTL=3600 "
              "TTL_COLUMN=ts")
    s.load_arrow("ev", pa.table({"id": np.arange(n, dtype=np.int64),
                                 "ts": pa.array(ts, pa.timestamp("us")), "v": v}))
    t0 = time.perf_counter()
    purged = s.execute("HANDLE ttl").affected_rows
    stats = {"rows": n, "purged": purged, "handle_ttl_s": time.perf_counter() - t0}
    if purged != int(expired.sum()):
        raise AssertionError(f"HANDLE ttl purged {purged}, numpy {int(expired.sum())}")
    left = s.query("SELECT COUNT(*) n, SUM(v) sv, SUM(id) si FROM ev")[0]
    keep = ~expired
    want = {"n": int(keep.sum()), "sv": int(v[keep].astype(np.int64).sum()),
            "si": int(np.arange(n)[keep].sum())}
    if left != want:
        raise AssertionError(f"rows left {left} != numpy {want}")
    ev = s.db.binlog.read(0)[-1]
    if (ev.event_type, ev.table, ev.affected) != ("delete", "ev", purged) or \
            not ev.statement.startswith("TTL purge ts < "):
        raise AssertionError(f"the binlog lacks the purge's event: {ev}")
    log(f"[lifecycle] HANDLE ttl purged {purged} of {n} rows in {stats['handle_ttl_s']:.2f} s; "
        "rows left equal numpy, the binlog holds its event")
    s.execute("DROP TABLE ev")
    return stats


def lifecycle_phase(gk, single, table, seed: int) -> tuple[dict, dict]:
    """Phase 14 (i)-(iii), in phase 3's session right after phase 11 (ii),
    over ``t`` as those writes left it; then (iv) and (v) on sessions of
    their own.  -> (launches, measurements)."""
    torch.cuda.reset_peak_memory_stats()
    s = single
    t0 = time.perf_counter()
    host = HostRows(htap_post_columns(table, seed)[1])
    stats: dict = {"seconds": {"numpy_state": time.perf_counter() - t0}}
    lane_before = lane_launches(gk)

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        stats["seconds"][name] = time.perf_counter() - t
        return out

    with flag(s, "streaming_scan", 0):
        s.execute("CREATE SUBSCRIPTION feed ON t")
        rl, stats["rollups"] = part("rollups", rollup_part, gk, s, host, seed)
        vl, stats["view"], events = part("view", view_part, gk, s, host, seed)
        # the lifecycle path's launches: each refresh's, the seed's and each
        # round's answer, read around the statement (the recomputes and the
        # warm repeats beside them are not counted)
        stats["launches_by_statement"] = {**rl, **vl}
        launches = {k: sum(d.get(k, 0) for d in stats["launches_by_statement"].values())
                    for k in all_launches(gk)}
        stats["lane_launches"] = {k: n - lane_before[k] for k, n in lane_launches(gk).items()}
        rows = host.cols["g"].shape[0]
        ins = lifecycle_rows(LC_INSERT_ROWS, seed + 141)
        first = ("insert", LC_INSERT_ROWS,
                 sorted(zip(*(ins[c].tolist() for c in ("g", "v", "w", "g16")))))
        stats["cdc"] = part("cdc", cdc_check, s, [first] + events)
        log(f"[lifecycle] FETCH: {stats['cdc']['events']} events equal the statements")
        store = s.db.stores["default.t"]
        batch = store.device_table_batch()
        sel = batch.sel_mask()
        stats["kernel_checks"] = part("kernel_checks", batch_kernel_checks, gk, batch, sel, sel,
                                      "[lifecycle]", "refreshed", True)
        del batch, sel
        if store.num_rows != rows:
            raise AssertionError(f"t holds {store.num_rows} rows, numpy {rows}")
        s.execute("DROP MATERIALIZED VIEW mv")
        s.execute("DROP SUBSCRIPTION feed")
        for name in ROLLUPS:
            s.execute(f"ALTER TABLE t DROP ROLLUP {name}")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["online_ddl"], sb_s = part("online_ddl", online_ddl_part, seed)
    stats["cdc_stream"] = part("cdc_stream", cdc_stream_part, sb_s, seed)
    sb_s.execute("DROP TABLE sbtest1")
    sb_s.db.close()
    del sb_s
    stats["ttl"] = part("ttl", ttl_part, seed)
    log("[lifecycle] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in stats["seconds"].items()))
    return launches, stats


# ----------------------------------------------------------------------
# phase 15: live-query introspection, KILL, SHOW STATUS / PROFILE, the
# flight recorder and users

OBS_TURNS = 3                    # alternating turns of progress_tracking = 1 / 0
OBS_TURN_REPS = 10
OBS_PROFILE_REPS = 5
OBS_KILL_AT = 763                # half of (b)'s 1,526 streamed chunks
OBS_CLIENTS = 16                 # D-b clients through the dispatcher in (iii)
OBS_KILLS = 4
OBS_POLL_S = 0.05                # the processlist poll period of (ii)
OBS_CHECKS = 1000                # access checks timed a query


def status_values(s, pattern: str) -> dict:
    """``SHOW STATUS LIKE pattern`` -> {name: float}, the numeric rows."""
    out = {}
    for r in s.query(f"SHOW STATUS LIKE '{pattern}'"):
        try:
            out[r["Variable_name"]] = float(r["Value"])
        except ValueError:        # health.status, health.watchdog
            pass
    return out


def kernel_status(s) -> tuple[dict, float]:
    """One SHOW STATUS: the kernel launch counters as it renders them, and
    ``query_latency.count``."""
    vals = status_values(s, "%.%")
    return ({k[len("kernel_launches."):-len(".value")]: int(v) for k, v in vals.items()
             if k.startswith("kernel_launches.") and k.endswith(".value")
             and not k.endswith("_lanes.value")}, vals["query_latency.count"])


def tracking_overhead(s) -> dict:
    """(a)-(c) warm in OBS_TURNS alternating turns of OBS_TURN_REPS runs with
    ``progress_tracking = 1`` and ``= 0`` (the flight recorder on in both):
    p50 / p67 of each side's runs, each turn's p50, and one profiled run of
    each side (device ms and idle share must not move with the beats)."""
    out = {}
    for q, sql in QUERIES.items():
        walls = {1: [], 0: []}
        turns = {1: [], 0: []}
        for _turn in range(OBS_TURNS):
            for on in (1, 0):
                with flag(s, "progress_tracking", on):
                    mine = []
                    for _ in range(OBS_TURN_REPS):
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        s.query(sql)
                        torch.cuda.synchronize()
                        mine.append((time.perf_counter() - t) * 1e3)
                walls[on] += mine
                turns[on].append(statistics.median(mine))
        res = {}
        for on, name in ((1, "on"), (0, "off")):
            w = sorted(walls[on])
            with flag(s, "progress_tracking", on):
                prof = device_breakdown(lambda: s.query(sql), statistics.median(w))
            res[name] = {"p50_ms": statistics.median(w), "p67_ms": w[len(w) - 11],
                         "turn_p50_ms": turns[on], "device_ms": prof["device_ms"],
                         "idle_share": prof["idle_share"]}
        out[q] = res
        log(f"[phase15] ({q}) progress_tracking on p50 {res['on']['p50_ms']:.3f} ms "
            f"(turns {[round(x, 3) for x in turns[1]]}), off {res['off']['p50_ms']:.3f} ms "
            f"(turns {[round(x, 3) for x in turns[0]]}); device "
            f"{fmt(res['on']['device_ms'], '.3f')} / {fmt(res['off']['device_ms'], '.3f')} ms, "
            f"idle {fmt(res['on']['idle_share'], '.3f')} / "
            f"{fmt(res['off']['idle_share'], '.3f')}")
    return out


def status_part(gk, s, refs) -> dict:
    """SHOW STATUS around one run each of (a)-(c): the ``kernel_launches.*``
    deltas equal phase 3's launches, ``query_latency`` counts the query and
    the SHOW before it, and the device gauges equal torch's reads beside
    them."""
    out = {}
    for q, sql in QUERIES.items():
        k0, l0 = kernel_status(s)
        rows = s.query(sql)
        torch.cuda.synchronize()
        k1, l1 = kernel_status(s)
        check_query(q, rows, refs)
        moved = {k: v - k0[k] for k, v in k1.items() if v != k0[k]}
        if moved != EXPECTED_LAUNCHES[q]:
            raise AssertionError(f"SHOW STATUS: ({q}) moved kernel_launches {moved}, "
                                 f"expected {EXPECTED_LAUNCHES[q]}")
        # the query itself and the SHOW STATUS read before it
        if l1 - l0 != 2:
            raise AssertionError(f"SHOW STATUS: query_latency moved {l1 - l0} over ({q})")
        out[q] = {"kernel_launches": moved, "query_latency_count": l1 - l0}
    hbm = status_values(s, "device_hbm_%.value")
    allocated = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if hbm["device_hbm_in_use_bytes.value"] != allocated:
        raise AssertionError(f"device_hbm_in_use_bytes {hbm['device_hbm_in_use_bytes.value']} "
                             f"!= memory_allocated {allocated}")
    if hbm["device_hbm_limit_bytes.value"] != total:
        raise AssertionError(f"device_hbm_limit_bytes {hbm['device_hbm_limit_bytes.value']} "
                             f"!= the card's {total}")
    out["device_hbm"] = {**hbm, "memory_allocated": allocated, "total_memory": total}
    log(f"[phase15] SHOW STATUS: kernel_launches deltas {[out[q]['kernel_launches'] for q in QUERIES]}"
        f", device_hbm_in_use_bytes {allocated}, limit {total}")
    return out


def flightrec_part(s) -> dict:
    """(b) under ``slow_query_ms = 1`` and tracing: its flight record
    carries a bundle with the plan, the spans and the card's memory."""
    sql = QUERIES["b"]
    with flag(s, "slow_query_ms", 1), flag(s, "tracing", 1):
        s.query(sql)
    rec = [r for r in s.db.flightrec.rows() if r["text"] == sql][-1]
    b = rec["bundle"]
    if b is None or "Agg" not in b["plan"] or not b["spans"]:
        raise AssertionError(f"flight record of (b) lacks its bundle: {rec}")
    dev = [d for d in b["device_stats"] if d["device"] == "cuda:0"]
    if len(dev) != 1 or not dev[0]["bytes_in_use"] > 0 or not dev[0]["bytes_limit"] > 0:
        raise AssertionError(f"flight record of (b): device_stats {b['device_stats']}")
    out = {"status": rec["status"], "dur_ms": rec["dur_ms"], "spans": len(b["spans"]),
           "plan_lines": len(b["plan"].splitlines()), "device_stats": dev[0],
           "phase_ms": rec["phase_ms"]}
    log(f"[phase15] flight record of (b): {rec['dur_ms']} ms, {len(b['spans'])} spans, "
        f"device_stats {dev[0]}")
    return out


def profile_part(s) -> dict:
    """(b) under ``tracing = 1``: SHOW PROFILE's root against the wall the
    client saw around ``execute`` (within 10%, median of the runs)."""
    from baikaldb_tpu_torch.obs import trace

    sql = QUERIES["b"]
    ratios, walls, roots = [], [], []
    with flag(s, "tracing", 1):
        for _ in range(OBS_PROFILE_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s.execute(sql)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            prof = s.query("SHOW PROFILE")
            if prof[0]["Status"] != "query":
                raise AssertionError(f"SHOW PROFILE's root is {prof[0]['Status']!r}")
            walls.append(wall)
            roots.append(prof[0]["Duration_ms"])
            ratios.append(prof[0]["Duration_ms"] / wall)
        stages = [r["Status"].strip() for r in s.query("SHOW PROFILE")]
    trace.TRACER.clear()
    ratio = statistics.median(ratios)
    if abs(ratio - 1.0) > 0.10:
        raise AssertionError(f"SHOW PROFILE root {roots} ms against walls {walls} ms")
    log(f"[phase15] SHOW PROFILE root / wall {[round(x, 3) for x in ratios]}, stages {stages}")
    return {"root_ms": roots, "wall_ms": walls, "ratio_p50": ratio, "stages": stages}


def users_part(gk, s, refs) -> dict:
    """``CREATE USER app``: (c) as app raises AccessError before any launch;
    after a grant on the table's database (c) gives numpy's rows with K1 1,
    K3 1.  The access check's host ms a query."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.meta.privileges import AccessError
    from baikaldb_tpu_torch.sql.parser import parse_sql

    sql = QUERIES["c"]
    s.execute("CREATE USER app")
    try:
        app = Session(s.db, user="app")
        before = all_launches(gk)
        try:
            app.query(sql)
        except AccessError:
            denied = True
        else:
            denied = False
        torch.cuda.synchronize()
        if not denied or all_launches(gk) != before:
            raise AssertionError("(c) as app without a grant was not denied before its launches")
        s.execute("GRANT SELECT ON default.* TO app")
        before = all_launches(gk)
        rows = app.query(sql)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
        check_query("c", rows, refs)
        if launched != EXPECTED_LAUNCHES["c"]:
            raise AssertionError(f"(c) as app launched {launched}")
        stmt = parse_sql(sql)[0]
        check_ms = {}
        for who, sess in (("root", s), ("app", app)):
            t = time.perf_counter()
            for _ in range(OBS_CHECKS):
                sess._access_check(stmt)
            check_ms[who] = (time.perf_counter() - t) * 1e3 / OBS_CHECKS
        grants = s.query("SHOW GRANTS FOR app")
    finally:
        s.execute("DROP USER IF EXISTS app")
    log(f"[phase15] users: denied before any launch; granted (c) launched {launched}; "
        f"access check {check_ms} ms a query")
    return {"denied_before_launch": True, "granted_launches": launched,
            "access_check_ms": check_ms, "grants": [r["Grants for app"] for r in grants]}


def observability_part(gk, s, refs) -> tuple[dict, dict]:
    """Phase 15 (i), right after phase 3 in its session over its unchanged
    rows.  -> (launches of its runs, measurements)."""
    t0 = time.perf_counter()
    # this path's launches: counters at 0 just before, read just after
    reset_launches(gk)
    with flag(s, "streaming_scan", 0):      # phase 3's resident path
        out = {"overhead": tracking_overhead(s), "status": status_part(gk, s, refs),
               "flightrec": flightrec_part(s), "profile": profile_part(s),
               "users": users_part(gk, s, refs)}
    launches = all_launches(gk)
    out["seconds"] = time.perf_counter() - t0
    return launches, out


def proc_row(s, conn_id: int) -> list:
    return s.query("SELECT operator, chunk_no, chunks_total, phase FROM "
                   f"information_schema.processlist WHERE id = {conn_id}")


def kill_streamed_part(gk, s, refs) -> tuple[dict, dict]:
    """Phase 15 (ii), in phase 4's session (``streaming_chunk_rows`` at its
    default): (b) streamed on a worker thread; a second session polls
    ``information_schema.processlist`` and, once ``chunk_no`` reaches
    OBS_KILL_AT, KILLs it.  The worker raises QueryKilled; then the card is
    as before the query, and the next (b) gives numpy's rows with one
    streamed run's launches.  -> (launches, measurements)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.obs.progress import QueryKilled
    from baikaldb_tpu_torch.utils import metrics
    from baikaldb_tpu_torch.utils.flags import FLAGS

    t_phase = time.perf_counter()
    sql = QUERIES["b"]
    n_chunks = -(-s.db.stores["default.t"].num_rows // int(FLAGS.streaming_chunk_rows))
    worker_s = Session(s.db)
    killer = Session(s.db)
    proc_row(killer, worker_s.connection_id())        # the poll's first run, before the baseline
    # this path's launches: counters at 0 just before, read just after
    reset_launches(gk)
    torch.cuda.synchronize()
    # small tensors of earlier runs wait in reference cycles (frames and
    # tracebacks) until the collector's pass: the baseline is taken after one
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    c0 = metrics.stream_chunks.value
    done = {}

    def work():
        try:
            worker_s.query(sql)
            done["outcome"] = "ran"
        except QueryKilled:
            done["outcome"] = "killed"
        except BaseException as e:      # noqa: BLE001 — reported below
            done["outcome"] = f"{type(e).__name__}: {e}"
        done["t"] = time.perf_counter()

    th = threading.Thread(target=work, name="phase15-worker")
    th.start()
    seen, kill = [], None
    deadline = time.perf_counter() + 120.0
    while th.is_alive() and time.perf_counter() < deadline:
        rows = proc_row(killer, worker_s.connection_id())
        if rows and rows[0]["chunks_total"]:
            r = rows[0]
            seen.append(r["chunk_no"])
            if r["operator"] != "StreamScan(default.t)":
                raise AssertionError(f"processlist operator {r['operator']!r}")
            if r["chunk_no"] >= OBS_KILL_AT:
                k_before = all_launches(gk)
                killer.execute(f"KILL QUERY {worker_s.connection_id()}")
                t_kill = time.perf_counter()
                c_at_kill = metrics.stream_chunks.value
                kill = {"chunk_no": r["chunk_no"], "chunks_total": r["chunks_total"],
                        "launches_before": {k: v for k, v in k_before.items() if v}}
                break
        time.sleep(OBS_POLL_S)
    th.join(60.0)
    if th.is_alive() or kill is None:
        raise AssertionError(f"the KILL of streamed (b) did not land: {done}, seen {seen[-3:]}")
    if done["outcome"] != "killed":
        raise AssertionError(f"the killed streamed (b) ended {done['outcome']}")
    torch.cuda.synchronize()
    kill["latency_ms"] = (done["t"] - t_kill) * 1e3
    kill["chunks_after_kill"] = metrics.stream_chunks.value - c_at_kill
    kill["chunks_folded"] = metrics.stream_chunks.value - c0
    if seen != sorted(seen):
        raise AssertionError(f"processlist chunk_no went down: {seen}")
    if kill["chunks_total"] != n_chunks or kill["chunks_folded"] >= n_chunks:
        raise AssertionError(f"the killed (b) folded {kill['chunks_folded']} of "
                             f"{kill['chunks_total']} chunks, expected fewer of {n_chunks}")
    stagers = [t.name for t in threading.enumerate() if t.name == "stream-prefetch"]
    mem1_before_gc = torch.cuda.memory_allocated()
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    live = proc_row(killer, worker_s.connection_id())
    stalls = s.db.watchdog.scan_now()
    rec = [r for r in s.db.flightrec.rows() if r["text"] == sql][-1]
    if stagers or mem1 != mem0 or live or stalls or rec["status"] != "killed" \
            or rec["bundle"] is None:
        raise AssertionError(f"after the KILL: stagers {stagers}, memory {mem1} vs {mem0}, "
                             f"processlist {live}, stalls {stalls}, record {rec['status']}")
    # the next streamed (b): numpy's rows with one streamed run's launches
    before = all_launches(gk)
    rows = s.query(sql)
    torch.cuda.synchronize()
    check_query("b", rows, refs)
    launched = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
    want = {k: n * n_chunks for k, n in STREAM_EXPECTED["b"].items()}
    if launched != want:
        raise AssertionError(f"the streamed (b) after the KILL launched {launched}, "
                             f"expected {want}")
    launches = all_launches(gk)
    out = {**kill, "polls": len(seen), "memory_before": mem0, "memory_after": mem1,
           "memory_after_before_gc": mem1_before_gc,
           "record": {"status": rec["status"], "dur_ms": rec["dur_ms"],
                      "phase_ms": rec["phase_ms"]},
           "next_run_launches": launched, "seconds": time.perf_counter() - t_phase}
    log(f"[phase15] (ii) KILL at chunk {kill['chunk_no']}/{kill['chunks_total']}: raised "
        f"{kill['latency_ms']:.2f} ms after KILL returned, {kill['chunks_after_kill']} chunks "
        f"folded after it, launches before {kill['launches_before']}; memory {mem1} == {mem0} "
        f"({mem1_before_gc} before the collector's pass); "
        f"next run launched {launched}")
    return launches, out


def kill_dispatch_part(gk, s, refs, seed: int) -> tuple[dict, dict, dict]:
    """Phase 15 (iii), after phase 12 (iii) in phase 3's session: OBS_CLIENTS
    clients of D-b through the dispatcher (tick D_TICK_MS); OBS_KILLS of
    them KILLed while ``information_schema.processlist`` shows them in
    ``exec.queued``.  A killed client raises QueryKilled (or, had its tick
    already taken it, returns its serial rows); every other client returns
    its serial rows bit for bit.  -> (one-lane launches, lane launches,
    measurements)."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.obs.progress import QueryKilled
    from baikaldb_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    stmts = [mine[0] for mine in d_statements("D-b", seed + 15)[:OBS_CLIENTS]]
    serial = {sql: s.execute(sql).arrow for sql, _ in stmts}
    for sql, args in stmts:
        check_d("D-b", args, serial[sql].to_pylist(), refs)
    sessions = [Session(s.db) for _ in stmts]
    ids = {x.connection_id(): i for i, x in enumerate(sessions)}
    killer = Session(s.db)
    got, outcome = {}, {}
    start = threading.Barrier(len(stmts) + 1)

    def client(i, x, sql):
        start.wait(60.0)
        try:
            got[i] = x.execute(sql).arrow
            outcome[i] = "rows"
        except QueryKilled:
            outcome[i] = "killed"
        except BaseException as e:      # noqa: BLE001 — reported below
            outcome[i] = f"{type(e).__name__}: {e}"

    reset_launches(gk)
    g0 = metrics.batched_groups.value
    killed = []
    with flag(s, "batch_dispatch_tick_ms", D_TICK_MS):
        ts = [threading.Thread(target=client, args=(i, x, sql))
              for i, (x, (sql, _)) in enumerate(zip(sessions, stmts))]
        for t in ts:
            t.start()
        start.wait(60.0)
        deadline = time.perf_counter() + 60.0
        # SHOW PROCESSLIST reads the records on the host; a SELECT over
        # information_schema.processlist runs on the card, where it waits
        # behind the tick's kernels on the same stream and sees the queue
        # only once it has drained
        while len(killed) < OBS_KILLS and any(t.is_alive() for t in ts) \
                and time.perf_counter() < deadline:
            for r in killer.query("SHOW PROCESSLIST"):
                if r["Id"] in ids and r["Id"] not in killed and len(killed) < OBS_KILLS \
                        and r["State"].split(" ", 1)[0] == "exec.queued":
                    killer.execute(f"KILL QUERY {r['Id']}")
                    killed.append(r["Id"])
        for t in ts:
            t.join(60.0)
    torch.cuda.synchronize()
    if any(t.is_alive() for t in ts):
        raise AssertionError("a dispatcher client did not finish")
    ticks = metrics.batched_groups.value - g0
    lanes = lane_launches(gk)
    inline = all_launches(gk)
    killed_i = {ids[c] for c in killed}
    for i, (sql, _) in enumerate(stmts):
        if outcome[i] == "rows":
            if not got[i].equals(serial[sql]):
                raise AssertionError(f"(iii) client {i}'s rows differ from its serial run")
        elif outcome[i] != "killed" or i not in killed_i:
            raise AssertionError(f"(iii) client {i} ended {outcome[i]}")
    if len(killed) != OBS_KILLS:
        raise AssertionError(f"(iii) saw {len(killed)} clients in exec.queued, wanted "
                             f"{OBS_KILLS}")
    if ticks < 1:
        raise AssertionError("(iii) no batched tick formed")
    for k, n in D_TICK_LAUNCHES["D-b"].items():
        if lanes[k] != n * ticks:
            raise AssertionError(f"(iii) {k} launched {lanes[k]} times over {ticks} ticks")
    out = {"clients": len(stmts), "killed": len(killed),
           "killed_raised": sum(1 for i in killed_i if outcome[i] == "killed"),
           "killed_returned_rows": sum(1 for i in killed_i if outcome[i] == "rows"),
           "survivors_equal_serial": sum(1 for i in outcome if i not in killed_i),
           "ticks": ticks, "lane_launches": {k: v for k, v in lanes.items() if v},
           "inline_launches": {k: v for k, v in inline.items() if v},
           "seconds": time.perf_counter() - t_phase}
    log(f"[phase15] (iii) {len(stmts)} D-b clients, {len(killed)} KILLed in exec.queued "
        f"({out['killed_raised']} raised, {out['killed_returned_rows']} returned rows); "
        f"{ticks} ticks, lane launches {out['lane_launches']}, inline {out['inline_launches']}")
    return inline, lanes, out


# ----------------------------------------------------------------------
# phase 16: the radix join and the host presort on TPC-H at --tpch-scale;
# the replicated tier (Raft regions, 2PC, the meta service, the store fleet)

PRESORT_TPCH = ("q3", "q10", "q18", "q21")   # listed whether or not they take one
PRESORT_TURNS = (4, 3, 3)        # 10 warm runs a side, in 3 alternating turns
RADIX_BUCKETS = 256
RADIX_QUERIES = ("q3", "q13")    # q3's joins are all dense; q13's LEFT JOIN is a sort join
RADIX_TURNS = (4, 3, 3)
# config #2's 10M rows, cut: ~70 us a replicated row on the host; 2^20 split
# at 262,144 before phase 17 came, cut to keep the script in its time limit
REP_ROWS = 1 << 18
REP_SPLIT_ROWS = 65_536          # a region splits at the threshold: 8 regions of 32,768 rows
REP_STORES = ("s1:8110", "s2:8110", "s3:8110")
REP_WRITES = 200                 # single-row autocommit writes, each a 1PC
REP_TXNS = 20                    # transactions over two regions, each a 2PC
REP_AFTER_KILL = 20
REP_REPS = 10
REP_DDL = "CREATE TABLE tr (id BIGINT PRIMARY KEY, g INT, v FLOAT, w DOUBLE, g16 INT)"
REP_COLS = ("id", "g", "v", "w", "g16")


@contextlib.contextmanager
def presort_stripped(s):
    """``s``'s batches without their ``__presort__`` keys: the JAX package's
    own way to run without the presort (its tests/test_ops.py)."""
    orig = s._collect_batches

    def strip(plan):
        b, k, full = orig(plan)
        return {kk: v for kk, v in b.items() if not str(kk).startswith("__presort__")}, k, full
    s._collect_batches = strip
    try:
        yield
    finally:
        del s._collect_batches


def presort_nodes(s, sql: str) -> list:
    """The plan nodes that took a presort in one run of ``sql``, each as
    "<node>: <its __presort__ key>"."""
    seen = []
    orig = s._collect_batches

    def spy(plan):
        out = orig(plan)
        stack = [plan]
        while stack:
            n = stack.pop()
            if getattr(n, "presort_input", None):
                seen.append(f"{type(n).__name__}: {n.presort_input}")
            stack.extend(n.children)
        return out
    s._collect_batches = spy
    try:
        s.query(sql)
        torch.cuda.synchronize()
    finally:
        del s._collect_batches
    return sorted(set(seen))


def alternating(s, sql: str, sides: dict, turns) -> dict:
    """Warm walls of ``sql`` under each side's context (a factory), side
    after side in each turn -> per side p50 / p67 and each turn's p50."""
    walls = {k: [] for k in sides}
    per_turn = {k: [] for k in sides}
    for n in turns:
        for name, ctx in sides.items():
            with ctx():
                w = []
                for _ in range(n):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s.query(sql)
                    torch.cuda.synchronize()
                    w.append((time.perf_counter() - t) * 1e3)
            walls[name] += w
            per_turn[name].append(statistics.median(w))
    return {k: {"warm_ms_p50": statistics.median(w),
                "warm_ms_p67": float(np.percentile(w, 67)), "turns_p50": per_turn[k]}
            for k, w in walls.items()}


def same_rows(what: str, got, want, sql: str) -> None:
    from baikaldb_tpu_torch.models.parity import mismatch

    diff = mismatch(got, want, sql, 1e-9)
    if diff is not None:
        raise AssertionError(f"{what}: {diff}")


def presort_part(s, first: dict) -> dict:
    """(i) Which TPC-H plan nodes take a presort; those queries with and
    without it in alternating turns, the first run after the permutations
    are dropped, their host argsort alone, one profiled run a side; the
    rows of both sides equal phase 5 (ii)'s."""
    from baikaldb_tpu_torch.models import tpch

    nodes = {q: presort_nodes(s, sql) for q, sql in tpch.QUERIES.items()}
    engaged = [q for q in tpch.QUERIES if nodes[q]]
    log(f"[presort] nodes with a presort: "
        + "; ".join(f"{q}: {nodes[q]}" for q in tpch.QUERIES if nodes[q] or q in PRESORT_TPCH))
    out = {"nodes": {q: nodes[q] for q in tpch.QUERIES if nodes[q] or q in PRESORT_TPCH},
           "queries": {}}
    for q in engaged:
        sql = tpch.QUERIES[q]
        stores = {k.split(": ", 1)[1].split("|")[1] for k in nodes[q]}
        # the first run with the permutations dropped: it pays the host
        # argsorts and the uploads, then their host part alone
        for tk in stores:
            s.db.stores[tk]._perm = (-1, {})
        torch.cuda.synchronize()
        t = time.perf_counter()
        on_rows = s.query(sql)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        argsort_s = 0.0
        for key in nodes[q]:
            kind, tk, cols = key.split(": ", 1)[1][len("__presort__"):].split("|")
            st = s.db.stores[tk]
            st._perm = (-1, {})
            t = time.perf_counter()
            (st.sort_permutation if kind == "join" else st.agg_sort_permutation)(
                tuple(cols.split(",")))
            argsort_s += time.perf_counter() - t
        s.query(sql)                     # the uploads again, before the timed turns
        with presort_stripped(s):
            off_rows = s.query(sql)
        same_rows(f"{q} with the presort vs phase 5 (ii)", on_rows, first[q], sql)
        same_rows(f"{q} without the presort vs phase 5 (ii)", off_rows, first[q], sql)
        walls = alternating(s, sql, {"presort": contextlib.nullcontext,
                                     "no_presort": lambda: presort_stripped(s)},
                            PRESORT_TURNS)
        for side, ctx in (("presort", contextlib.nullcontext),
                          ("no_presort", lambda: presort_stripped(s))):
            with ctx():
                walls[side].update(device_breakdown(lambda: s.query(sql),
                                                    walls[side]["warm_ms_p50"]))
            walls[side]["index_add_kernels"] = sum(
                "indexFunc" in k for k in walls[side].pop("kernel_names"))
        out["queries"][q] = {"first_s": first_s, "host_argsort_s": argsort_s, **walls}
        log(f"[presort] {q}: p50 {walls['presort']['warm_ms_p50']:.2f} ms with the presort "
            f"vs {walls['no_presort']['warm_ms_p50']:.2f} without (turns "
            f"{walls['presort']['turns_p50']} / {walls['no_presort']['turns_p50']}); device "
            f"{fmt(walls['presort']['device_ms'], '.2f')} / "
            f"{fmt(walls['no_presort']['device_ms'], '.2f')} ms, "
            f"idle {fmt(walls['presort']['idle_share'], '.3f')} / "
            f"{fmt(walls['no_presort']['idle_share'], '.3f')}; "
            f"first run {first_s:.3f} s, host argsort {argsort_s:.3f} s; rows equal")
    return out


def radix_part(s, first: dict) -> dict:
    """(i) The radix join on TPC-H: for each of RADIX_QUERIES, the joins
    that take the radix path at ``radix_join_buckets`` = 256 (with the
    presort kept, else stripped, else also at ``radix_join_min_build`` = 1)
    and their widths.  The first query where one does runs against 0 in
    alternating turns, rows equal to phase 5 (ii)'s; then ``radix_join``
    alone against the sort ``join`` alone at its largest radix build and
    that build's probe.  q3's joins are all dense PK-FK joins, which the
    radix gate never takes (the JAX executor's gate); q13's LEFT JOIN of
    customer to orders is the one sort join of the 22 queries, and it takes
    the presort, which the gate refuses, so its radix side runs stripped."""
    from baikaldb_tpu_torch.models import tpch
    from baikaldb_tpu_torch.ops import join as join_ops

    calls: list = []
    orig = join_ops.radix_join

    def spy(probe, pkeys, build, bkeys, how="inner", **kw):
        res = orig(probe, pkeys, build, bkeys, how=how, **kw)
        calls.append({"build_rows": len(build), "probe_rows": len(probe), "keys": list(bkeys),
                      "how": how, "width": res[2], "args": (probe, pkeys, build, bkeys, how, kw)})
        return res

    modes = [("presort kept", contextlib.nullcontext, 65536),
             ("presort stripped", lambda: presort_stripped(s), 65536),
             ("presort stripped, radix_join_min_build = 1", lambda: presort_stripped(s), 1)]
    out: dict = {"engaged": {}}
    join_ops.radix_join = spy
    try:
        for q in RADIX_QUERIES:
            sql = tpch.QUERIES[q]
            for mode, strip, min_build in modes:
                with strip(), flag(s, "radix_join_buckets", RADIX_BUCKETS), \
                        flag(s, "radix_join_min_build", min_build):
                    rows = s.query(sql)
                    torch.cuda.synchronize()
                if calls:
                    break
            out["engaged"][q] = {"mode": mode if calls else None,
                                 "joins": [{k: v for k, v in c.items() if k != "args"}
                                           for c in calls]}
            if calls:
                break
    finally:
        join_ops.radix_join = orig
    if not calls:
        raise AssertionError(f"{RADIX_QUERIES}: no join took the radix path")
    same_rows(f"{q} under the radix join vs phase 5 (ii)", rows, first[q], sql)

    @contextlib.contextmanager
    def radix_side():
        with strip(), flag(s, "radix_join_buckets", RADIX_BUCKETS), \
                flag(s, "radix_join_min_build", min_build):
            yield
    walls = alternating(s, sql, {"radix": radix_side, "sort": contextlib.nullcontext},
                        RADIX_TURNS)
    big = max(calls, key=lambda c: c["build_rows"])
    probe, pkeys, build, bkeys, how, kw = big["args"]
    calls.clear()
    radix_ms = device_ms(lambda: join_ops.radix_join(probe, pkeys, build, bkeys, how=how, **kw))
    sort_ms = device_ms(lambda: join_ops.join(probe, pkeys, build, bkeys, how=how,
                                              wide_keys_ok=kw.get("wide_keys_ok", False)))
    del probe, build, big
    largest = max(out["engaged"][q]["joins"], key=lambda c: c["build_rows"])
    out.update({"query": q, "mode": mode, **walls,
                "largest_build": {**largest, "radix_join_device_ms": radix_ms,
                                  "join_device_ms": sort_ms}})
    log(f"[radix] engaged: {out['engaged']}; {q} ({mode}): p50 "
        f"{walls['radix']['warm_ms_p50']:.2f} ms radix vs {walls['sort']['warm_ms_p50']:.2f} "
        f"sort join; at its largest build ({out['largest_build']['build_rows']} rows, probe "
        f"{out['largest_build']['probe_rows']}) radix_join {radix_ms:.3f} device-ms vs join "
        f"{sort_ms:.3f}; rows equal")
    return out


class Replay:
    """The numpy state of ``tr`` under every acknowledged write."""

    def __init__(self, table):
        n = table.num_rows
        cap = n + REP_WRITES + REP_AFTER_KILL
        self.cols = {c: np.zeros(cap, table.column(c).type.to_pandas_dtype())
                     for c in REP_COLS}
        for c in REP_COLS:
            self.cols[c][:n] = table.column(c).to_numpy()
        self.live = np.zeros(cap, bool)
        self.live[:n] = True
        self.n = n
        self.at = {}                     # id -> slot, for ids written after the load

    def slot(self, i: int) -> int:
        return self.at.get(i, i)

    def update(self, i: int, v: float, w: float) -> None:
        k = self.slot(i)
        self.cols["v"][k], self.cols["w"][k] = v, w

    def insert(self, row: dict) -> None:
        k = self.n
        self.n += 1
        for c in REP_COLS:
            self.cols[c][k] = row[c]
        self.live[k] = True
        self.at[row["id"]] = k

    def delete(self, i: int) -> None:
        self.live[self.slot(i)] = False

    def table(self) -> dict:
        m = self.live[:self.n]
        order = np.argsort(self.cols["id"][:self.n][m], kind="stable")
        return {c: a[:self.n][m][order] for c, a in self.cols.items()}

    def refs(self) -> dict:
        t = self.table()
        keep_v = (t["v"] * np.float32(2) + np.float32(1)).astype(np.float64) > 0.5
        return {"a": reference(t["g16"], t["v"], keep_v, 16),
                "b": reference(t["g"], t["v"], keep_v, 2048),
                "c": reference(t["g"], t["w"], t["w"] > -1, 2048)}


def rep_queries(gk, s, refs: dict, tag: str) -> dict:
    """(a)-(c) over ``tr``: each launches exactly phase 3's kernels and
    equals numpy; warm p50 / p67 of REP_REPS runs, one profiled run."""
    out = {}
    for q, sql in QUERIES.items():
        sql = sql.replace(" FROM t ", " FROM tr ")
        before = all_launches(gk)
        rows = s.query(sql)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
        if got != EXPECTED_LAUNCHES[q]:
            raise AssertionError(f"{tag} ({q}) launched {got}, expected {EXPECTED_LAUNCHES[q]}")
        check_query(q, rows, refs)
        out[q] = {"launches": got, **timed_query(s, sql, REP_REPS)}
    log(f"{tag} (a)-(c) equal numpy with phase 3's launches; warm p50 "
        + ", ".join(f"({q}) {v['warm_ms_p50']:.2f} ms / {fmt(v['device_ms'], '.2f')} device-ms"
                    for q, v in out.items()))
    return out


def rep_writes(s, statements: list) -> list:
    """Each statement's wall milliseconds (autocommit, one at a time)."""
    ms = []
    for sql in statements:
        t = time.perf_counter()
        s.execute(sql)
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def replicated_phase(gk, seed: int) -> tuple[dict, dict]:
    """(ii) BASELINE.json config #2 (GROUP BY over 8 regions) deployed as
    BaikalDB deploys a region, a 3-replica Raft group: a fleet of 3 stores
    under ``MetaService(peer_count=3)``, ``tr`` of REP_ROWS rows split into
    8 regions.  The load through Raft and the splits, SHOW REGIONS and the
    regions' leaders, (a)-(c), 1PC writes against a plain session's, 2PC
    transactions and a rollback, a leader kill and the writes after it,
    then a fresh Database rebuilt from the replicas: its rows equal the
    numpy replay of every acknowledged write, its (a)-(c) launch phase 3's
    kernels and equal numpy, the kernels against their plain versions on
    its batch.  -> (launches, measurements)."""
    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.meta.service import MetaService
    from baikaldb_tpu_torch.raft import twopc
    from baikaldb_tpu_torch.raft.fleet import StoreFleet
    from baikaldb_tpu_torch.utils.flags import FLAGS

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base, _ = sql_table(REP_ROWS, seed)
    table = pa.table({"id": np.arange(REP_ROWS, dtype=np.int64),
                      **{c: base.column(c) for c in ("g", "v", "w", "g16")}})
    del base
    replay = Replay(table)
    rng = np.random.default_rng(seed + 16)
    prev_split = FLAGS.get("region_split_rows")
    prev_stream = FLAGS.get("streaming_scan")
    FLAGS.set_flag("streaming_scan", "0")       # resident, as phase 3
    out: dict = {"rows": REP_ROWS, "stores": list(REP_STORES)}
    try:
        fleet = StoreFleet(MetaService(peer_count=3), list(REP_STORES), seed=seed + 1)
        s = Session(Database("cuda", fleet=fleet))
        s.execute(REP_DDL)
        tier = fleet.row_tiers["default.tr"]
        tier.split_rows = 1 << 62                  # the load first, the splits apart
        t = time.perf_counter()
        s.load_arrow("tr", table)
        out["load_s"] = time.perf_counter() - t
        out["load_rows_per_s"] = REP_ROWS / out["load_s"]
        FLAGS.set_flag("region_split_rows", str(REP_SPLIT_ROWS))
        tier.split_rows = 0
        t = time.perf_counter()
        out["splits"] = tier.maybe_split()
        out["split_s"] = time.perf_counter() - t
        fleet.heartbeat_all()
        regions = s.query("SELECT region_id, leader, peers, num_rows FROM "
                          "information_schema.regions ORDER BY region_id")
        out["regions"] = regions
        out["show_regions"] = s.query("SHOW REGIONS")
        if len(regions) != 8 or len(tier.groups) != 8:
            raise AssertionError(f"[replicated] {len(regions)} regions, expected 8")
        log(f"[replicated] {REP_ROWS} rows through Raft in {out['load_s']:.2f} s "
            f"({out['load_rows_per_s']:.0f} rows/s), {out['splits']} splits in "
            f"{out['split_s']:.2f} s: {len(regions)} regions, leaders "
            f"{[r['leader'] for r in regions]}; SHOW REGIONS lists {len(out['show_regions'])} "
            f"column region(s)")

        # the replicated path: counters at 0 just before, read after the
        # rebuilt Database's queries
        reset_launches(gk)
        out["queries"] = rep_queries(gk, s, replay.refs(), "[replicated]")

        # 1PC: single-row autocommit writes, beside a plain session's
        plain = Session(device="cuda")
        plain.execute(REP_DDL)
        plain.load_arrow("tr", table)
        del table
        stmts, next_id = [], REP_ROWS
        for i in range(REP_WRITES):
            kind = ("update", "insert", "delete")[i % 3]
            if kind == "insert":
                row = {"id": next_id, "g": int(rng.integers(0, 2048)),
                       "v": float(rng.integers(-16, 16)) / 8,
                       "w": float(rng.integers(-1000, 1000)) / 16, "g16": int(rng.integers(0, 16))}
                next_id += 1
                replay.insert(row)
                stmts.append(f"INSERT INTO tr VALUES ({row['id']}, {row['g']}, {row['v']}, "
                             f"{row['w']}, {row['g16']})")
                continue
            i_d = int(rng.integers(0, REP_ROWS))
            while not replay.live[replay.slot(i_d)]:
                i_d = int(rng.integers(0, REP_ROWS))
            if kind == "update":
                v, w = float(rng.integers(-16, 16)) / 8, float(rng.integers(-1000, 1000)) / 16
                replay.update(i_d, v, w)
                stmts.append(f"UPDATE tr SET v = {v}, w = {w} WHERE id = {i_d}")
            else:
                replay.delete(i_d)
                stmts.append(f"DELETE FROM tr WHERE id = {i_d}")
        out["writes_1pc"] = {**percentiles(rep_writes(s, stmts)),
                             "plain": percentiles(rep_writes(plain, stmts))}
        del plain

        # 2PC: two rows in the first and the last region a transaction
        calls = []
        orig_write = twopc.TwoPhaseCoordinator.write

        def counted(self, *a, **kw):
            calls.append(1)
            return orig_write(self, *a, **kw)
        twopc.TwoPhaseCoordinator.write = counted
        span = REP_ROWS // 8
        walls = []
        try:
            for i in range(REP_TXNS + 1):
                a, b = int(rng.integers(0, span)), int(rng.integers(REP_ROWS - span, REP_ROWS))
                while not (replay.live[replay.slot(a)] and replay.live[replay.slot(b)]):
                    a, b = int(rng.integers(0, span)), int(rng.integers(REP_ROWS - span, REP_ROWS))
                va, vb = float(rng.integers(-16, 16)) / 8, float(rng.integers(-16, 16)) / 8
                end = "ROLLBACK" if i == REP_TXNS else "COMMIT"
                t = time.perf_counter()
                for sql in ("BEGIN", f"UPDATE tr SET v = {va} WHERE id = {a}",
                            f"UPDATE tr SET v = {vb} WHERE id = {b}", end):
                    s.execute(sql)
                if end == "COMMIT":
                    walls.append((time.perf_counter() - t) * 1e3)
                    replay.update(a, va, replay.cols["w"][replay.slot(a)])
                    replay.update(b, vb, replay.cols["w"][replay.slot(b)])
        finally:
            twopc.TwoPhaseCoordinator.write = orig_write
        if len(calls) != REP_TXNS:
            raise AssertionError(f"[replicated] {len(calls)} 2PCs for {REP_TXNS} commits")
        out["txns_2pc"] = {**percentiles(walls), "rolled_back": 1}

        # the leader kill: the store leading the most regions
        leaders = [g.leader() for g in tier.groups]
        victim = fleet._addr[max(set(leaders), key=leaders.count)]
        fleet.kill_store(victim)
        stmts = []
        for _ in range(REP_AFTER_KILL):
            i_d = int(rng.integers(0, REP_ROWS))
            while not replay.live[replay.slot(i_d)]:
                i_d = int(rng.integers(0, REP_ROWS))
            v, w = float(rng.integers(-16, 16)) / 8, float(rng.integers(-1000, 1000)) / 16
            replay.update(i_d, v, w)
            stmts.append(f"UPDATE tr SET v = {v}, w = {w} WHERE id = {i_d}")
        ms = rep_writes(s, stmts)
        out["leader_kill"] = {"victim": victim, "regions_led": leaders.count(
            fleet._ids[victim]), "first_write_ms": ms[0], **percentiles(ms)}
        del s

        # the rebuild: a fresh Database over the fleet, from the replicas
        torch.cuda.synchronize()
        t = time.perf_counter()
        s2 = Session(Database("cuda", fleet=fleet))
        s2.execute(REP_DDL)
        store = s2.db.stores["default.tr"]
        batch = store.device_table_batch()
        torch.cuda.synchronize()
        out["rebuild_s"] = time.perf_counter() - t
        snap = store.snapshot()
        order = np.argsort(snap.column("id").to_numpy(), kind="stable")
        want = replay.table()
        for c in REP_COLS:
            got = snap.column(c).to_numpy()[order]
            if not np.array_equal(got, want[c]):
                raise AssertionError(f"[replicated] the rebuilt column {c} differs from the replay")
        log(f"[replicated] rebuilt from the replicas in {out['rebuild_s']:.2f} s: "
            f"{snap.num_rows} rows equal the replay of every acknowledged write")
        del snap
        out["rebuilt_queries"] = rep_queries(gk, s2, replay.refs(), "[replicated, rebuilt]")
        launches = all_launches(gk)
        col = dict(zip(batch.names, batch.columns))
        v, w = col["v"].data, col["w"].data
        out["kernel_checks"] = batch_kernel_checks(gk, batch, (v * 2 + 1).double() > 0.5, w > -1,
                                                   "[replicated]", "rebuilt")
        del batch, col, v, w
        out["memory_allocated_gib"] = torch.cuda.memory_allocated() / 2**30
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        fleet.revive_store(victim)
        fleet.heartbeat_all()
        s2.execute(f"UPDATE tr SET v = 0.5 WHERE id = {int(want['id'][0])}")
        out["revived"] = victim
        del s2
    finally:
        FLAGS.set_flag("region_split_rows", str(prev_split))
        FLAGS.set_flag("streaming_scan", str(int(prev_stream)))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[replicated] 1PC p50 / p99 {out['writes_1pc']['p50_ms']:.2f} / "
        f"{out['writes_1pc']['p99_ms']:.2f} ms (plain {out['writes_1pc']['plain']['p50_ms']:.2f} / "
        f"{out['writes_1pc']['plain']['p99_ms']:.2f}), 2PC {out['txns_2pc']['p50_ms']:.2f} / "
        f"{out['txns_2pc']['p99_ms']:.2f} ms, first write after killing {victim} "
        f"{out['leader_kill']['first_write_ms']:.2f} ms; memory "
        f"{out['memory_allocated_gib']:.3f} GiB, peak {out['peak_mem_gib']:.3f} GiB; "
        f"{out['seconds']:.1f} s")
    return launches, out


# ----------------------------------------------------------------------
# phase 17: the network plane, the store and meta daemons, pushed
# fragments, the cold tier's segments and the distributed binlog

# config #2's 10M rows, cut further than phase 16 (ii): a pushed query folds
# every row in Python on the stores, and the phase must fit 100 s
CL_ROWS = 1 << 18
CL_SPLIT_ROWS = 65_536           # a region splits at the threshold: 8 regions of 32,768 rows
CL_LOAD_ROWS = CL_SPLIT_ROWS // 2    # rows a write of the load (a ~2 MB frame)
CL_PUSH_REPS = 3                 # warm runs of a pushed query (the stores fold row by row)
# a commit waits for the daemons' raft tick (50 ms)
CL_WRITES = 100                  # single-row autocommit writes, each a 1PC: enough for a p99
CL_TXNS = 20                     # two-region transactions, each a 2PC (phase 16's count)
CL_BINLOG_WRITES = 8             # BINLOG=1 writes before the store kill, alternating frontends
CL_BINLOG_AFTER = 4              # and after it (12 and 6 until the 1PC / 2PC counts grew)
CL_POLL_S = 30.0                 # the capturer's deadline to see every event


def row_refs(table: dict) -> dict:
    """(a)-(c)'s references under the row-wise predicate of a pushed
    fragment: ``v*2+1 > 0.5`` in float64 (the daemons fold Python floats),
    where the device evaluates it in float32."""
    keep_v = table["v"].astype(np.float64) * 2 + 1 > 0.5
    return {"a": reference(table["g16"], table["v"], keep_v, 16),
            "b": reference(table["g"], table["v"], keep_v, 2048),
            "c": reference(table["g"], table["w"], table["w"] > -1, 2048)}


def pushed_queries(s, refs: dict, tag: str, queries=QUERIES, reps: int = CL_PUSH_REPS) -> dict:
    """(a)-(c) (or ``queries``) over ``tr`` as pushed fragments: each
    dispatches, launches no kernel and equals numpy; the first run
    publishes the fragment, ``reps`` warm runs re-dispatch it by its key (no
    compile anywhere).  -> per query: the first run's ms, the warm p50 /
    p67 (with ``reps`` > 0) and the counters."""
    from baikaldb_tpu_torch.ops import group_kernels as gk
    from baikaldb_tpu_torch.utils import metrics

    out = {}
    for q, sql in queries.items():
        sql = sql.replace(" FROM t ", " FROM tr ")
        d0, b0 = metrics.fragments_dispatched.value, metrics.fragment_bytes_saved.value
        f0 = metrics.fragment_fallbacks.value
        before = all_launches(gk)
        t = time.perf_counter()
        rows = s.query(sql)
        first_ms = (time.perf_counter() - t) * 1e3
        check_query(q, rows, refs)
        if metrics.fragments_dispatched.value == d0 or metrics.fragment_fallbacks.value != f0:
            raise AssertionError(f"{tag} ({q}) did not run as a pushed fragment: "
                                 f"{metrics.fragments_dispatched.value - d0} dispatched, "
                                 f"{metrics.fragment_fallbacks.value - f0} fallbacks in "
                                 f"{first_ms:.0f} ms")
        if all_launches(gk) != before:
            raise AssertionError(f"{tag} ({q}) launched kernels on the pushed path")
        c0 = metrics.fragment_warm_compiles.value
        d1 = metrics.fragments_dispatched.value
        walls = [first_ms]
        for _ in range(reps):
            t = time.perf_counter()
            s.query(sql)
            walls.append((time.perf_counter() - t) * 1e3)
        out[q] = {"first_ms": first_ms, "warm_runs": reps,
                  **({"warm_ms_p50": statistics.median(walls[1:]),
                      "warm_ms_p67": float(np.percentile(walls[1:], 67))} if reps else {}),
                  "fragments_dispatched": metrics.fragments_dispatched.value - d0,
                  "fragments_a_run": d1 - d0,
                  "fragment_bytes_saved": metrics.fragment_bytes_saved.value - b0,
                  "fragment_bytes_saved_a_run":
                      (metrics.fragment_bytes_saved.value - b0) // (reps + 1),
                  "warm_compiles_on_redispatch": metrics.fragment_warm_compiles.value - c0}
        if out[q]["warm_compiles_on_redispatch"] or \
                metrics.fragment_fallbacks.value != f0:
            raise AssertionError(f"{tag} ({q}) re-dispatch compiled or fell back: {out[q]}")
    what = f"warm p50 of {reps}" if reps else "a single first run"
    log(f"{tag} pushed {', '.join(f'({q})' for q in out)} equal numpy, no kernel launched; "
        f"{what}: " + ", ".join(
            f"({q}) {v['warm_ms_p50'] if reps else v['first_ms']:.1f} ms "
            f"({v['fragments_a_run']} fragments, {v['fragment_bytes_saved_a_run']} bytes "
            f"saved a run)"
            for q, v in out.items()))
    return out


def region_leaders(stores: list, region_ids: set) -> dict:
    """store address -> the regions of ``region_ids`` it leads, asked of
    each live daemon (``region_status``)."""
    from baikaldb_tpu_torch.raft.core import LEADER
    from baikaldb_tpu_torch.utils.net import RpcClient

    out = {}
    for addr in stores:
        st = RpcClient(addr, timeout=5.0).try_call("region_status") or {}
        out[addr] = sorted(int(r) for r, v in st.items()
                           if int(r) in region_ids and v["role"] == LEADER)
    return out


def card_pids() -> list:
    """The pids ``nvidia-smi`` lists as holding the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def maps_libcuda(pid: int) -> bool:
    """Has process ``pid`` loaded libcuda (the first step of a context)?"""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def sees_no_card(pid: int) -> bool:
    """Does process ``pid`` run with ``CUDA_VISIBLE_DEVICES`` empty (it can
    load libcuda but open no context on any card)?"""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
    except OSError:
        return False
    return b"CUDA_VISIBLE_DEVICES=" in env


def capture_all(cap, want: set, deadline_s: float) -> tuple[list, list]:
    """Poll the capturer until every id of ``want`` arrived -> (entries,
    each poll's wall ms)."""
    got, polls = [], []
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        t = time.perf_counter()
        batch = cap.poll()
        polls.append((time.perf_counter() - t) * 1e3)
        got += batch
        seen = {ev["row"]["id"] for e in got for ev in e["events"] if "row" in ev}
        if want <= seen:
            return got, polls
        if not batch:
            time.sleep(0.05)
    raise AssertionError(f"[cluster] the capturer saw {len(got)} entries, "
                         f"missing ids {sorted(want - seen)[:10]}")


def cluster_phase(gk, seed: int) -> tuple[dict, dict]:
    """Phase 17 (module docstring) -> (launches of B's warm (a)-(c),
    measurements)."""
    import shutil
    import tempfile

    import pyarrow as pa

    from baikaldb_tpu_torch.exec.session import Database, Session
    from baikaldb_tpu_torch.storage import remote_tier
    from baikaldb_tpu_torch.storage.binlog_regions import BinlogCapturer
    from baikaldb_tpu_torch.storage.remote_tier import ClusterClient
    from baikaldb_tpu_torch.tools.deploy_cluster import spawn_cluster, teardown, wait_frontends
    from baikaldb_tpu_torch.utils import metrics
    from baikaldb_tpu_torch.utils.flags import FLAGS

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base, _ = sql_table(CL_ROWS, seed)
    table = pa.table({"id": np.arange(CL_ROWS, dtype=np.int64),
                      **{c: base.column(c) for c in ("g", "v", "w", "g16")}})
    del base
    replay = Replay(table)
    rng = np.random.default_rng(seed + 17)
    root = tempfile.mkdtemp(prefix="bk_cluster_phase_")
    cold = os.path.join(root, "cold")
    prev = {k: FLAGS.get(k) for k in ("region_split_rows", "streaming_scan", "pushdown_reads")}
    FLAGS.set_flag("streaming_scan", "0")        # resident, as phase 3
    FLAGS.set_flag("region_split_rows", str(CL_SPLIT_ROWS))
    out: dict = {"rows": CL_ROWS, "stores": 3}
    dbs: list = []
    procs = None
    try:
        t = time.perf_counter()
        # phase 18 (ii)'s frontend process starts with the daemons, on the
        # card, and imports the engine while the load runs
        meta, procs = spawn_cluster(3, 0, aot_dir=os.path.join(root, "aot"), cold_dir=cold,
                                    mysql_port=free_port())
        out["spawn_s"] = time.perf_counter() - t
        addrs = list(procs["store_addresses"])

        def frontend():
            db = Database("cuda", cluster=meta, cold_dir=cold)
            dbs.append(db)
            s = Session(db)
            s.execute(REP_DDL)
            return s

        # (1) the load through frontend A, splitting at the threshold
        a = frontend()
        tier = a.db.stores["default.tr"].replicated
        tier.split_rows = 1 << 62                  # the splits apart from the writes
        load_s = split_s = 0.0
        steps = []
        for lo in range(0, CL_ROWS, CL_LOAD_ROWS):
            t = time.perf_counter()
            a.load_arrow("tr", table.slice(lo, CL_LOAD_ROWS))
            steps.append(time.perf_counter() - t)
            load_s += steps[-1]
            if lo + CL_LOAD_ROWS >= CL_SPLIT_ROWS:
                t = time.perf_counter()
                tier.split_rows = 0                # the flag: region_split_rows
                tier.maybe_split()
                tier.split_rows = 1 << 62
                steps.append(time.perf_counter() - t)
                split_s += steps[-1]
            log(f"[cluster] {lo + CL_LOAD_ROWS} rows loaded, {len(tier.regions)} regions "
                f"(steps {[round(x, 2) for x in steps[-2:]]} s)")
        out["load_steps_s"] = steps
        out.update(load_s=load_s, load_rows_per_s=CL_ROWS / load_s, split_s=split_s,
                   regions=len(tier.regions))
        if len(tier.regions) != 8:
            raise AssertionError(f"[cluster] {len(tier.regions)} regions, expected 8 (load and "
                                 f"split steps {steps} s)")
        rids = {r.region_id for r in tier.regions}
        log(f"[cluster] meta + 3 store processes up in {out['spawn_s']:.1f} s; {CL_ROWS} rows "
            f"over TCP in {load_s:.2f} s ({out['load_rows_per_s']:.0f} rows/s), splits "
            f"{split_s:.2f} s: 8 regions, leaders {region_leaders(addrs, rids)}")

        # (2) pushed on A
        FLAGS.set_flag("pushdown_reads", "always")
        out["pushed"] = pushed_queries(a, row_refs(replay.table()), "[cluster]")

        # (3)-(5) frontend B under auto: pushed while unattached, then the
        # pull, then the card
        FLAGS.set_flag("pushdown_reads", "auto")
        b = frontend()
        store = b.db.stores["default.tr"]
        out["b_first_pushed"] = pushed_queries(b, row_refs(replay.table()), "[cluster, B]",
                                               {"a": QUERIES["a"]}, reps=0)["a"]
        if not store.attach_pending:
            raise AssertionError("[cluster] B's pushed (a) pulled the table")
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = store.device_table_batch()
        torch.cuda.synchronize()
        out["attach_s"] = time.perf_counter() - t
        if store.num_rows != CL_ROWS:
            raise AssertionError(f"[cluster] B attached {store.num_rows} rows")
        reset_launches(gk)
        out["queries"] = rep_queries(gk, b, replay.refs(), "[cluster, B attached]")
        launches = all_launches(gk)
        col = dict(zip(batch.names, batch.columns))
        v, w = col["v"].data, col["w"].data
        out["kernel_checks"] = batch_kernel_checks(gk, batch, (v * 2 + 1).double() > 0.5, w > -1,
                                                   "[cluster]", "attached")
        del batch, col, v, w
        log(f"[cluster] B attached {CL_ROWS} rows (pull over TCP + stage) in "
            f"{out['attach_s']:.2f} s")

        # phase 18 (ii): the frontend process answers (a)-(c) as B does
        b_rows = {q: b.query(sql.replace(" FROM t ", " FROM tr ")) for q, sql in QUERIES.items()}
        out["frontend"] = frontend_part(wait_frontends(procs)[0], b_rows, replay.refs())

        # (7) writes through A: 1PC, then 2PC over the first and last region
        stmts, next_id = [], CL_ROWS
        for i in range(CL_WRITES):
            kind = ("update", "insert", "delete")[i % 3]
            if kind == "insert":
                row = {"id": next_id, "g": int(rng.integers(0, 2048)),
                       "v": float(rng.integers(-16, 16)) / 8,
                       "w": float(rng.integers(-1000, 1000)) / 16, "g16": int(rng.integers(0, 16))}
                next_id += 1
                replay.insert(row)
                stmts.append(f"INSERT INTO tr VALUES ({row['id']}, {row['g']}, {row['v']}, "
                             f"{row['w']}, {row['g16']})")
                continue
            i_d = int(rng.integers(0, CL_ROWS))
            while not replay.live[replay.slot(i_d)]:
                i_d = int(rng.integers(0, CL_ROWS))
            if kind == "update":
                v_, w_ = float(rng.integers(-16, 16)) / 8, float(rng.integers(-1000, 1000)) / 16
                replay.update(i_d, v_, w_)
                stmts.append(f"UPDATE tr SET v = {v_}, w = {w_} WHERE id = {i_d}")
            else:
                replay.delete(i_d)
                stmts.append(f"DELETE FROM tr WHERE id = {i_d}")
        out["writes_1pc"] = percentiles(rep_writes(a, stmts))
        calls = []
        orig = remote_tier._twopc_remote

        def counted(*args, **kw):
            calls.append(1)
            return orig(*args, **kw)
        remote_tier._twopc_remote = counted
        span, walls = CL_ROWS // 8, []
        try:
            for _ in range(CL_TXNS):
                x, y = int(rng.integers(0, span)), int(rng.integers(CL_ROWS - span, CL_ROWS))
                while not (replay.live[replay.slot(x)] and replay.live[replay.slot(y)]):
                    x, y = int(rng.integers(0, span)), int(rng.integers(CL_ROWS - span, CL_ROWS))
                vx, vy = float(rng.integers(-16, 16)) / 8, float(rng.integers(-16, 16)) / 8
                t = time.perf_counter()
                for sql in ("BEGIN", f"UPDATE tr SET v = {vx} WHERE id = {x}",
                            f"UPDATE tr SET v = {vy} WHERE id = {y}", "COMMIT"):
                    a.execute(sql)
                walls.append((time.perf_counter() - t) * 1e3)
                replay.update(x, vx, replay.cols["w"][replay.slot(x)])
                replay.update(y, vy, replay.cols["w"][replay.slot(y)])
        finally:
            remote_tier._twopc_remote = orig
        if len(calls) != CL_TXNS:
            raise AssertionError(f"[cluster] {len(calls)} 2PCs for {CL_TXNS} commits")
        out["txns_2pc"] = percentiles(walls)
        log(f"[cluster] over TCP: 1PC p50 / p99 {out['writes_1pc']['p50_ms']:.2f} / "
            f"{out['writes_1pc']['p99_ms']:.2f} ms of {CL_WRITES}, 2PC p50 / p99 "
            f"{out['txns_2pc']['p50_ms']:.2f} / {out['txns_2pc']['p99_ms']:.2f} ms of {CL_TXNS}")

        # (8) the cold tier: flush, (a) pushed over the daemons' cold
        # segments (no fallback), GC
        FLAGS.set_flag("pushdown_reads", "always")
        t = time.perf_counter()
        flushed = a.execute("HANDLE cold_flush default.tr").affected_rows
        out["cold"] = {"flushed_rows": flushed, "flush_s": time.perf_counter() - t,
                       "status": a.query("HANDLE cold_status default.tr")[0]}
        f0 = metrics.fragment_fallbacks.value
        out["cold"]["pushed"] = pushed_queries(a, row_refs(replay.table()), "[cluster, cold]",
                                               {"a": QUERIES["a"]}, reps=0)["a"]
        out["cold"]["fallbacks"] = metrics.fragment_fallbacks.value - f0
        t = time.perf_counter()
        out["cold"]["gc_reclaimed"] = a.execute("HANDLE cold_gc default.tr").affected_rows
        out["cold"]["gc_s"] = time.perf_counter() - t
        out["cold"]["segments"] = len(a.query("SELECT file FROM information_schema.cold_segments"))
        if out["cold"]["fallbacks"] or flushed < CL_ROWS:
            raise AssertionError(f"[cluster] cold: {out['cold']}")
        log(f"[cluster] cold_flush {flushed} rows in {out['cold']['flush_s']:.2f} s; (a) pushed "
            f"over the cold segments in {out['cold']['pushed']['first_ms']:.1f} ms (one run), "
            f"no fallback; cold_gc reclaimed {out['cold']['gc_reclaimed']} file(s)")

        # (9) the distributed binlog, written by both frontends
        for s in (a, b):
            s.execute("CREATE TABLE bt (id BIGINT NOT NULL, v DOUBLE, PRIMARY KEY (id)) BINLOG=1")
        cap = BinlogCapturer(ClusterClient(meta))
        cap.poll()
        t = time.perf_counter()
        for i in range(CL_BINLOG_WRITES):
            (a if i % 2 == 0 else b).execute(f"INSERT INTO bt VALUES ({i}, {i * 0.5})")
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        got, polls = capture_all(cap, set(range(CL_BINLOG_WRITES)), CL_POLL_S)
        n_events = sum(len(e["events"]) for e in got)
        out["binlog"] = {"writes": CL_BINLOG_WRITES, "write_s": write_s,
                         "events": n_events, "capture_s": time.perf_counter() - t,
                         "events_per_s": n_events / max(1e-9, sum(polls) / 1e3),
                         "polls": len(polls), "poll_p50_ms": statistics.median(polls)}
        ts = [e["commit_ts"] for e in got]
        if ts != sorted(ts) or len({e["src"] for e in got}) != 2:
            raise AssertionError("[cluster] the binlog stream is out of order or not both "
                                 "frontends'")

        # (10) SIGKILL the store leading the most regions
        led = region_leaders(addrs, rids)
        victim = max(led, key=lambda k: len(led[k]))
        k = addrs.index(victim)
        procs["stores"][k].kill()
        procs["stores"][k].wait(timeout=30)
        i_d = int(rng.integers(0, CL_ROWS))
        while not replay.live[replay.slot(i_d)]:
            i_d = int(rng.integers(0, CL_ROWS))
        t = time.perf_counter()
        a.execute(f"UPDATE tr SET v = 0.25 WHERE id = {i_d}")
        first_ms = (time.perf_counter() - t) * 1e3
        replay.update(i_d, 0.25, replay.cols["w"][replay.slot(i_d)])
        after = []
        for i in range(CL_BINLOG_WRITES, CL_BINLOG_WRITES + CL_BINLOG_AFTER):
            t = time.perf_counter()
            (a if i % 2 == 0 else b).execute(f"INSERT INTO bt VALUES ({i}, {i * 0.5})")
            after.append((time.perf_counter() - t) * 1e3)
        got2, _ = capture_all(cap, set(range(CL_BINLOG_WRITES, CL_BINLOG_WRITES + CL_BINLOG_AFTER)),
                              CL_POLL_S)
        ids = sorted(ev["row"]["id"] for e in got + got2 for ev in e["events"] if "row" in ev)
        if ids != list(range(CL_BINLOG_WRITES + CL_BINLOG_AFTER)):
            raise AssertionError("[cluster] the capturer lost or repeated events across the kill")
        out["store_kill"] = {"victim": victim, "regions_led": len(led[victim]),
                             "first_write_ms": first_ms,
                             "binlog_writes_after": percentiles(after),
                             "events_lost": 0}
        log(f"[cluster] binlog: {n_events} events of both frontends in one ordered stream, "
            f"{out['binlog']['events_per_s']:.0f} events/s, poll p50 "
            f"{out['binlog']['poll_p50_ms']:.2f} ms; SIGKILL {victim} (led "
            f"{len(led[victim])} regions): first write {first_ms:.1f} ms, no event lost")

        # (11) a fresh frontend rebuilds hot + cold
        FLAGS.set_flag("pushdown_reads", "auto")
        c = frontend()
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap = c.db.stores["default.tr"].snapshot()
        out["rebuild_s"] = time.perf_counter() - t
        order = np.argsort(snap.column("id").to_numpy(), kind="stable")
        want = replay.table()
        for col_name in REP_COLS:
            if not np.array_equal(snap.column(col_name).to_numpy()[order], want[col_name]):
                raise AssertionError(f"[cluster] the rebuilt column {col_name} differs "
                                     f"from the replay")
        out["rebuilt_rows"] = snap.num_rows
        del snap

        # (12) cluster_metrics from every live daemon
        c.db.telemetry.poll()
        rows = c.query("SELECT daemon, stale FROM information_schema.cluster_metrics")
        live = {meta, *(x for x in addrs if x != victim)}
        fresh = {r["daemon"] for r in rows if r["stale"] == 0}
        out["cluster_metrics"] = {d: sum(1 for r in rows if r["daemon"] == d)
                                  for d in sorted({r["daemon"] for r in rows})}
        if not live <= fresh:
            raise AssertionError(f"[cluster] cluster_metrics lacks live daemons "
                                 f"{sorted(live - fresh)}")

        # (13) which processes hold the card: this one and the frontend
        # process (phase 18 (ii))
        holders = card_pids()
        front = procs["mysql"]
        live_pids = [p.pid for p in [procs["meta"], *procs["stores"]] if p.poll() is None]
        seeing = [p for p in live_pids
                  if p in holders or not sees_no_card(p) or maps_libcuda(p)]
        ours = {os.getpid(), front.pid}
        out["card_pids"] = {"nvidia_smi": holders, "smoke": os.getpid(),
                            "frontend_process": front.pid,
                            "frontend_maps_libcuda": maps_libcuda(front.pid),
                            "daemons": live_pids, "daemons_seeing_a_card": seeing}
        # a container's nvidia-smi may name processes by another pid
        # namespace's ids: two processes hold the card (where the ids are
        # ours, exactly these two), the frontend process has loaded libcuda,
        # and no daemon can see a card or has loaded libcuda
        if seeing or len(holders) != 2 or (set(holders) <= ours and set(holders) != ours) \
                or front.poll() is not None or not maps_libcuda(front.pid):
            raise AssertionError(f"[cluster] the card is held by {out['card_pids']}")
        log(f"[cluster] fresh frontend rebuilt {out['rebuilt_rows']} rows (hot + cold) in "
            f"{out['rebuild_s']:.2f} s, equal to the replay; cluster_metrics rows "
            f"{out['cluster_metrics']}; nvidia-smi lists {holders} (this process "
            f"{os.getpid()}, the frontend process {front.pid}), no daemon sees a card or "
            f"loads libcuda")
        out["memory_allocated_gib"] = torch.cuda.memory_allocated() / 2**30
    finally:
        for db in dbs:
            db.close()
        if procs is not None:
            teardown(procs)
        for k, val in prev.items():
            FLAGS.set_flag(k, str(int(val)) if isinstance(val, bool) else str(val))
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[cluster] {out['seconds']:.1f} s")
    return launches, out



# ----------------------------------------------------------------------
# phase 18: the MySQL wire over the 100M rows, a frontend process over the
# TCP cluster, the chaos scenarios on the card

WIRE_REPS = 10                   # warm runs of (a)-(c), over the wire and in process
WIRE_POOL = 8                    # Pool connections sending prepared D-a
WIRE_PREPARED = 4                # D-a executes a connection, behind one barrier each
WIRE_KILL_PHASE = "egress.arrow"  # the victim's beat at which KILL CONNECTION is sent:
#                                   its kernels ran, its result is on the card
FRONT_REPS = 3                   # warm runs of (a)-(c) through the frontend process
CHAOS_STREAM_ROWS = 262_144
CHAOS_STREAM_CHUNK = 16_384
FLEET_PLANE = ("kill_leader", "partition", "split_chaos", "migrate_chaos", "snapshot_chaos")


def wire_values(res) -> list:
    """A wire result (every value text) -> dicts by column name: a GROUP BY
    key and COUNT(*) as int, the rest as float, NULL as None."""
    out = []
    for row in res.rows:
        d = {}
        for name, v in zip(res.columns, row):
            if v is None:
                d[name] = None
            elif name == res.columns[0] or name.upper().startswith("COUNT"):
                d[name] = int(v)
            else:
                d[name] = float(v)
        out.append(d)
    return out


def same_rows_rtol(tag: str, got: list, want: list, rtol: float = 1e-4) -> None:
    """Group keys and counts exact, every other value within ``rtol``."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} rows, expected {len(want)}")
    for a, b in zip(got, want):
        av, bv = list(a.values()), list(b.values())
        if av[0] != bv[0] or (len(av) == 5 and av[1] != bv[1]):
            raise AssertionError(f"{tag}: row {a} differs from {b}")
        for x, y in zip(av, bv):
            if not (x == y or abs(x - y) <= rtol * max(abs(x), abs(y))):
                raise AssertionError(f"{tag}: row {a} differs from {b} beyond rtol {rtol}")


def wire_walls(fn, reps: int) -> dict:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return {"p50_ms": statistics.median(walls), "p67_ms": float(np.percentile(walls, 67))}


def wire_part(gk, single, refs, drefs, seed: int) -> tuple[dict, dict, dict]:
    """Phase 18 (i), right after phase 15 (i) in phase 3's session over its
    unchanged 100M rows: an in-process ``MySQLServer`` on its Database.
    -> (launches through the wire, lane launches, measurements)."""
    from baikaldb_tpu_torch.client.mysql_client import Connection, Pool, PreparedStatement
    from baikaldb_tpu_torch.obs import progress
    from baikaldb_tpu_torch.server.mysql_server import MySQLServer
    from baikaldb_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    s = single
    out: dict = {"queries": {}}
    srv = MySQLServer(s.db, port=0).start()
    conns = []
    try:
        with flag(s, "streaming_scan", 0):
            # the in-process answers and walls first, outside the wire's count
            mine = {}
            for q, sql in QUERIES.items():
                mine[q] = s.query(sql)
                out["queries"][q] = {"inproc": wire_walls(lambda sql=sql: s.query(sql),
                                                          WIRE_REPS)}
            # the wire path: counters at 0 just before, read just after
            reset_launches(gk)
            c = Connection(port=srv.port)
            conns.append(c)
            for q, sql in QUERIES.items():
                before = all_launches(gk)
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = c.query(sql)
                torch.cuda.synchronize()
                first_ms = (time.perf_counter() - t) * 1e3
                got = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
                if got != EXPECTED_LAUNCHES[q]:
                    raise AssertionError(f"[wire] ({q}) launched {got}, expected "
                                         f"{EXPECTED_LAUNCHES[q]}")
                rows = wire_values(res)
                check_query(q, rows, refs)
                same_rows_rtol(f"[wire] ({q}) against the session", rows, mine[q])
                out["queries"][q].update(first_ms=first_ms, launches=got,
                                         wire=wire_walls(lambda sql=sql: c.query(sql),
                                                         WIRE_REPS))
                w, i = out["queries"][q]["wire"], out["queries"][q]["inproc"]
                log(f"[wire] ({q}) equal numpy and the session's rows; wire p50 / p67 "
                    f"{w['p50_ms']:.2f} / {w['p67_ms']:.2f} ms, in process "
                    f"{i['p50_ms']:.2f} / {i['p67_ms']:.2f} ms")

            # 8 Pool connections, 4 prepared D-a each, through the dispatcher
            pool = Pool("127.0.0.1", srv.port, size=WIRE_POOL)
            mine_conns = [pool.acquire() for _ in range(WIRE_POOL)]
            conns += mine_conns
            form = D_SHAPES["D-a"].replace("{x}", "?")
            stmts = [PreparedStatement(pc, form) for pc in mine_conns]
            rng = np.random.default_rng(seed + 18)
            xs = [[round(float(rng.normal()) * 0.5, 3) for _ in range(WIRE_PREPARED)]
                  for _ in range(WIRE_POOL)]
            barrier = threading.Barrier(WIRE_POOL)
            got_d, lat, errs = {}, [], []

            def client(i):
                try:
                    for k in range(WIRE_PREPARED):
                        barrier.wait(120)
                        t = time.perf_counter()
                        got_d[(i, k)] = stmts[i].execute((xs[i][k],))
                        lat.append((time.perf_counter() - t) * 1e3)
                except BaseException as e:      # noqa: BLE001 — re-raised below
                    errs.append(e)
                    barrier.abort()

            g0, f0 = metrics.batched_groups.value, metrics.dispatch_fallbacks.value
            lanes0 = lane_launches(gk)
            with flag(s, "batch_dispatch_tick_ms", D_TICK_MS):
                ths = [threading.Thread(target=client, args=(i,)) for i in range(WIRE_POOL)]
                t = time.perf_counter()
                for th in ths:
                    th.start()
                for th in ths:
                    th.join()
                pool_s = time.perf_counter() - t
            if errs:
                raise errs[0]
            for (i, k), res in got_d.items():
                check_d("D-a", {"x": xs[i][k]}, wire_values(res), drefs)
            lanes = {k: v - lanes0[k] for k, v in lane_launches(gk).items()}
            out["prepared"] = {"connections": WIRE_POOL, "executes": len(got_d),
                               "wall_s": pool_s, "p50_ms": statistics.median(lat),
                               "p99_ms": float(np.percentile(lat, 99)),
                               "ticks": metrics.batched_groups.value - g0,
                               "fallbacks": metrics.dispatch_fallbacks.value - f0,
                               "lane_launches": lanes}
            if not lanes["segment_reduce_lanes"]:
                raise AssertionError(f"[wire] the prepared D-a statements launched no lane "
                                     f"kernel: {out['prepared']}")
            log(f"[wire] {len(got_d)} prepared D-a executes from {WIRE_POOL} Pool connections "
                f"equal numpy: {out['prepared']['ticks']} ticks, lanes {lanes}, p50 "
                f"{out['prepared']['p50_ms']:.2f} ms")
            for st in stmts:
                st.close()

            # KILL CONNECTION of a wire client mid-query, its result on the card
            victim = Connection(port=srv.port)
            killer = Connection(port=srv.port)
            conns += [victim, killer]
            vid = int(victim.query("SELECT CONNECTION_ID()").rows[0][0])
            victim.query(QUERIES["b"])                       # warm, outside the baseline
            torch.cuda.synchronize()
            gc.collect()
            mem0 = torch.cuda.memory_allocated()
            QP = progress.QueryProgress
            real = QP.beat
            fired: dict = {}

            def beat(self, phase=None, operator=None, **counts):
                real(self, phase, operator, **counts)
                if not fired and self.conn_id == vid and self.phase == WIRE_KILL_PHASE:
                    fired["memory_at_kill"] = torch.cuda.memory_allocated()
                    fired["t"] = time.perf_counter()
                    th = threading.Thread(
                        target=lambda: fired.setdefault(
                            "ok", killer.query(f"KILL CONNECTION {vid}").affected_rows == 0))
                    th.start()
                    th.join(60.0)
            QP.beat = beat
            try:
                try:
                    victim.query(QUERIES["b"])
                    outcome = "ran"
                except (ConnectionError, OSError):
                    outcome = "severed"
                t_end = time.perf_counter()
            finally:
                QP.beat = real
            deadline = time.monotonic() + 30
            while vid in s.db.processlist and time.monotonic() < deadline:
                time.sleep(0.01)
            torch.cuda.synchronize()
            gc.collect()
            mem1 = torch.cuda.memory_allocated()
            if outcome != "severed" or not fired.get("ok") or vid in s.db.processlist \
                    or mem1 != mem0 or fired["memory_at_kill"] <= mem0:
                raise AssertionError(f"[wire] KILL CONNECTION: {outcome}, {fired}, memory "
                                     f"{mem1} vs {mem0}, processlist {sorted(s.db.processlist)}")
            rows = wire_values(killer.query(QUERIES["b"]))      # the server still answers
            check_query("b", rows, refs)
            # from the KILL's send to the victim's client seeing its socket closed
            out["kill"] = {"at_phase": WIRE_KILL_PHASE, "severed_ms": (t_end - fired["t"]) * 1e3,
                           "memory_before": mem0, "memory_at_kill": fired["memory_at_kill"],
                           "memory_after": mem1}
            log(f"[wire] KILL CONNECTION at the victim's {WIRE_KILL_PHASE} beat: its client "
                f"saw the socket closed {out['kill']['severed_ms']:.2f} ms after the KILL was "
                f"sent; memory "
                f"{mem1} == {mem0} ({fired['memory_at_kill']} at the kill)")
            launches = all_launches(gk)
            lane_n = lane_launches(gk)
    finally:
        for cn in conns:
            cn.close()
        srv.stop(close_db=False)
    missing = [k for k, n in launches.items() if n == 0 and k != WIDE]
    if missing or not lane_n["segment_reduce_lanes"]:
        raise AssertionError(f"[wire] kernels not launched through the wire: {missing}, "
                             f"lanes {lane_n}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[wire] {out['seconds']:.1f} s; launches {launches}, lanes {lane_n}")
    return launches, lane_n, out


def free_port() -> int:
    """A port bound and released (the frontend process binds it)."""
    import socket

    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    return port


def frontend_status(c) -> dict:
    """The frontend process's kernel launch counters (SHOW STATUS)."""
    out = {}
    for name, value in c.query("SHOW STATUS LIKE 'kernel_launches.%'").rows:
        if name.endswith(".value"):
            out[name[len("kernel_launches."):-len(".value")]] = int(float(value))
    return out


def frontend_part(port: int, b_rows: dict, refs: dict) -> dict:
    """Phase 18 (ii), inside phase 17 after frontend B's queries: the
    frontend process spawned with the cluster (``python -m
    baikaldb_tpu_torch.server --meta ...`` on the card) pulls ``tr`` and
    answers (a)-(c) over the wire: rows equal B's (keys and counts exact,
    float sums to rtol 1e-4) and numpy; its own counters show the kernels."""
    from baikaldb_tpu_torch.client.mysql_client import Connection

    t_phase = time.perf_counter()
    c = Connection(port=port)
    try:
        c.query("SET GLOBAL pushdown_reads = 'off'")     # pull the image, as B did
        c.query("SET GLOBAL streaming_scan = 0")
        t = time.perf_counter()
        c.query(REP_DDL)                                   # the pull over TCP
        out = {"pull_s": time.perf_counter() - t, "queries": {}}
        k0 = frontend_status(c)
        for q, sql in QUERIES.items():
            sql = sql.replace(" FROM t ", " FROM tr ")
            t = time.perf_counter()
            res = c.query(sql)
            first_ms = (time.perf_counter() - t) * 1e3
            rows = wire_values(res)
            check_query(q, rows, refs)
            same_rows_rtol(f"[frontend] ({q}) against frontend B", rows, b_rows[q])
            walls = []
            for _ in range(FRONT_REPS):
                t = time.perf_counter()
                c.query(sql)
                walls.append((time.perf_counter() - t) * 1e3)
            out["queries"][q] = {"first_ms": first_ms, "warm_ms_p50": statistics.median(walls)}
        k1 = frontend_status(c)
        launched = {k: v - k0.get(k, 0) for k, v in k1.items() if v != k0.get(k, 0)}
        want = {}
        for q in QUERIES:
            for k, n in EXPECTED_LAUNCHES[q].items():
                want[k] = want.get(k, 0) + n * (1 + FRONT_REPS)
        if launched != want:
            raise AssertionError(f"[frontend] the process launched {launched}, expected {want}")
        out["launches"] = launched
    finally:
        c.close()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[frontend] the frontend process pulled tr in {out['pull_s']:.2f} s and answered "
        f"(a)-(c) over the wire equal to frontend B and numpy, launching {launched}; "
        + ", ".join(f"({q}) first {v['first_ms']:.1f} ms, warm p50 {v['warm_ms_p50']:.1f} ms"
                    for q, v in out["queries"].items()))
    return out


def chaos_part(gk, seed: int) -> tuple[dict, dict, dict]:
    """Phase 18 (iii): the ten chaos scenarios on the card at their
    defaults, the fleet-plane ones twice (equal digests), then stream_chaos
    over CHAOS_STREAM_ROWS rows in CHAOS_STREAM_CHUNK-row chunks.  ->
    (launches, lane launches, measurements)."""
    from baikaldb_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario, stream_chaos

    t_phase = time.perf_counter()
    out: dict = {"seed": seed, "scenarios": {}}
    reset_launches(gk)
    for name in SCENARIOS:
        t = time.perf_counter()
        r = run_scenario(name, seed, device="cuda")
        dt = time.perf_counter() - t
        if not r["ok"]:
            raise AssertionError(f"[chaos] {name} on the card: {r.get('problems')} "
                                 f"{r.get('error')}")
        out["scenarios"][name] = {"seconds": dt, "faults": r.get("faults"),
                                  "state_digest": r["state_digest"]}
        if name in FLEET_PLANE:
            again = run_scenario(name, seed, device="cuda")
            if (again["state_digest"], again["fault_schedule"]) != \
                    (r["state_digest"], r["fault_schedule"]):
                raise AssertionError(f"[chaos] {name} did not replay from seed {seed}")
            out["scenarios"][name]["replayed"] = True
        log(f"[chaos] {name} ok in {dt:.2f} s, digest {r['state_digest']}")
    t = time.perf_counter()
    r = stream_chaos(rows=CHAOS_STREAM_ROWS, chunk_rows=CHAOS_STREAM_CHUNK, device="cuda")
    n_chunks = CHAOS_STREAM_ROWS // CHAOS_STREAM_CHUNK
    if r["problems"] or r["chunks"] != n_chunks or \
            any(e[2] != n_chunks for e in r["fault_schedule"]):
        raise AssertionError(f"[chaos] stream_chaos at {CHAOS_STREAM_ROWS} rows: {r}")
    out["stream_chaos_big"] = {"rows": CHAOS_STREAM_ROWS, "chunks": r["chunks"],
                               "passes": r["fault_schedule"],
                               "seconds": time.perf_counter() - t}
    launches, lanes = all_launches(gk), lane_launches(gk)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[chaos] stream_chaos over {CHAOS_STREAM_ROWS} rows: {n_chunks} chunks a pass, "
        f"every faulted pass equal to the resident answer ({r['fault_schedule']}) in "
        f"{out['stream_chaos_big']['seconds']:.1f} s; launches {launches}, lanes {lanes}; "
        f"{out['seconds']:.1f} s")
    return launches, lanes, out


# ----------------------------------------------------------------------
# phase 19: the analysis plane — the runtime guards on the card
# (analysis/runtime.py: the sync guard, the ranked locks, the lockset witness)

GUARD_REPS = 5                   # runs of (a)-(c) a side, guards on and off in turns
GUARD_THREADS = 8                # (iii): threads, each with its own session
GUARD_PREPARED = 4               # (iii): prepared D-a executes a thread, a barrier each


@contextlib.contextmanager
def counted_host_reads():
    """Count ``host_read`` calls: every module of the port that imported it
    gets a counting wrapper for the block -> the live counts ({"n": calls,
    "sites": {"file:line": calls}}, by the port's calling line)."""
    from baikaldb_tpu_torch.analysis import runtime as rt

    real, n = rt.host_read, {"n": 0, "sites": {}}

    def counted(*a, **kw):
        f = sys._getframe(1)
        where = f.f_code.co_filename.split("baikaldb_tpu_torch/")[-1] + f":{f.f_lineno}"
        n["n"] += 1
        n["sites"][where] = n["sites"].get(where, 0) + 1
        return real(*a, **kw)

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("baikaldb_tpu_torch") and m is not None
            and getattr(m, "host_read", None) is real]
    for m in mods:
        m.host_read = counted
    try:
        yield n
    finally:
        for m in mods:
            m.host_read = real


def guard_trips() -> dict:
    from baikaldb_tpu_torch.analysis import runtime as rt

    return {"transfer": rt.guard_transfer_trips.value, "lock": rt.guard_lock_trips.value,
            "owner": rt.guard_owner_trips.value}


def guard_part_i(gk, s, refs) -> tuple[dict, dict]:
    """(i) (a)-(c) over phase 3's 100M rows under ``debug_guards =
    disallow``, GUARD_REPS runs a side in turns with ``off``: 0 trips, rows
    equal numpy, phase 3's launches a run, host reads a query."""
    from baikaldb_tpu_torch.utils.flags import set_flag

    out = {}
    launches = dict.fromkeys(REPLACES, 0)
    t0 = time.perf_counter()
    set_flag("debug_guards", "disallow")     # arms the witness (the static parse)
    set_flag("debug_guards", "off")
    out["arm_s"] = time.perf_counter() - t0
    for q, sql in QUERIES.items():
        walls = {"off": [], "disallow": []}
        trips0 = guard_trips()
        reads, first = [], None
        for _ in range(GUARD_REPS):
            for mode in ("off", "disallow"):
                set_flag("debug_guards", mode)
                before = all_launches(gk)
                with counted_host_reads() as n:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    rows = s.query(sql)
                    torch.cuda.synchronize()
                    walls[mode].append((time.perf_counter() - t) * 1e3)
                set_flag("debug_guards", "off")
                got = {k: v - before[k] for k, v in all_launches(gk).items() if v != before[k]}
                if got != EXPECTED_LAUNCHES[q]:
                    raise AssertionError(f"[guards] ({q}) under {mode} launched {got}, "
                                         f"expected {EXPECTED_LAUNCHES[q]}")
                if mode == "disallow":
                    reads.append(n["n"])
                    for k, v in got.items():
                        launches[k] += v
                    if first is None:
                        first = rows
                        check_query(q, rows, refs)
        trips = {k: v - trips0[k] for k, v in guard_trips().items()}
        if any(trips.values()):
            raise AssertionError(f"[guards] ({q}) tripped the guards under disallow: {trips}")
        out[q] = {"p50_off_ms": statistics.median(walls["off"]),
                  "p50_disallow_ms": statistics.median(walls["disallow"]),
                  "walls_ms": walls, "host_reads": reads, "trips": trips,
                  "launches": EXPECTED_LAUNCHES[q]}
        log(f"[guards] ({q}) under disallow: rows equal numpy, 0 trips, launches "
            f"{EXPECTED_LAUNCHES[q]}, host reads a query {reads}; p50 on / off "
            f"{out[q]['p50_disallow_ms']:.3f} / {out[q]['p50_off_ms']:.3f} ms")
    return launches, out


def guard_part_ii(s, queries: dict) -> dict:
    """(ii) each TPC-H query once under ``log`` in the timed TPC-H session:
    the sync warnings caught on this thread (by file:line of the port's
    caller) and the host reads, a query."""
    import warnings

    from baikaldb_tpu_torch.analysis import runtime as rt
    from baikaldb_tpu_torch.utils.flags import set_flag

    out = {}
    set_flag("debug_guards", "log")
    try:
        for name, sql in queries.items():
            trips0 = rt.guard_transfer_trips.value
            with warnings.catch_warnings(record=True) as caught, counted_host_reads() as n:
                warnings.simplefilter("always")
                rows = s.query(sql)
                torch.cuda.synchronize()
            sites: dict = {}
            for w in caught:
                if rt.SYNC_TEXT in str(w.message):
                    where = w.filename.split("baikaldb_tpu_torch/")[-1] + f":{w.lineno}"
                    sites[where] = sites.get(where, 0) + 1
            out[name] = {"rows": len(rows), "host_reads": n["n"], "read_sites": n["sites"],
                         "sync_warnings": sum(sites.values()), "sites": sites,
                         "transfer_trips": rt.guard_transfer_trips.value - trips0}
    finally:
        set_flag("debug_guards", "off")
    total, reads = {}, {}
    for name, v in out.items():
        for k, c in v["sites"].items():
            total[k] = total.get(k, 0) + c
        for k, c in v["read_sites"].items():
            reads.setdefault(k, {})[name] = c
    log(f"[guards] TPC-H under log: host reads {sum(v['host_reads'] for v in out.values())} "
        f"at {reads}, sync warnings {sum(v['sync_warnings'] for v in out.values())} at {total}")
    return out


def guard_part_iii(gk, s, drefs, seed: int) -> tuple[dict, dict]:
    """(iii) GUARD_THREADS threads x GUARD_PREPARED prepared D-a through the
    dispatcher under ``disallow``, the telemetry poller and the watchdog
    running: 0 owner and 0 rank trips, every answer equal numpy, the
    segment kernel's lane entry launched."""
    from baikaldb_tpu_torch.exec.session import Session
    from baikaldb_tpu_torch.utils.flags import set_flag

    db = s.db
    form = D_SHAPES["D-a"].replace("{x}", "?")
    sessions = [Session(db) for _ in range(GUARD_THREADS)]
    for ss in sessions:
        ss.execute(f"PREPARE da FROM '{form}'")
    rng = np.random.default_rng(seed + 19)
    xs = [[round(float(rng.normal()) * 0.5, 3) for _ in range(GUARD_PREPARED)]
          for _ in range(GUARD_THREADS)]
    barrier = threading.Barrier(GUARD_THREADS)
    got, lat, errs = {}, [], []

    def client(i):
        try:
            for k in range(GUARD_PREPARED):
                barrier.wait(120)
                t = time.perf_counter()
                sessions[i].execute(f"SET @x = {xs[i][k]}")
                got[(i, k)] = sessions[i].execute("EXECUTE da USING @x").to_pylist()
                lat.append((time.perf_counter() - t) * 1e3)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            errs.append(e)
            barrier.abort()

    trips0 = guard_trips()
    lanes0, one0 = lane_launches(gk), all_launches(gk)
    set_flag("debug_guards", "disallow")
    db.telemetry.start(interval_s=0.02)
    db.watchdog.start(interval_s=0.02)
    try:
        with flag(s, "batch_dispatch_tick_ms", D_TICK_MS):
            ths = [threading.Thread(target=client, args=(i,)) for i in range(GUARD_THREADS)]
            t = time.perf_counter()
            for th in ths:
                th.start()
            for th in ths:
                th.join()
            wall = time.perf_counter() - t
    finally:
        db.telemetry.stop()
        db.watchdog.stop()
        set_flag("debug_guards", "off")
    if errs:
        raise errs[0]
    for (i, k), rows in got.items():
        check_d("D-a", {"x": xs[i][k]}, rows, drefs)
    trips = {k: v - trips0[k] for k, v in guard_trips().items()}
    lanes = {k: v - lanes0[k] for k, v in lane_launches(gk).items()}
    one = {k: v - one0[k] for k, v in all_launches(gk).items()}
    if trips["owner"] or trips["lock"]:
        raise AssertionError(f"[guards] the burst tripped the witness or the ranks: {trips}")
    if not lanes["segment_reduce_lanes"]:
        raise AssertionError(f"[guards] the burst launched no lane kernel: {lanes}")
    out = {"threads": GUARD_THREADS, "executes": len(got), "wall_s": wall,
           "p50_ms": statistics.median(lat), "trips": trips, "lane_launches": lanes,
           "launches": one}
    log(f"[guards] burst of {len(got)} prepared D-a under disallow with the poller and the "
        f"watchdog: trips {trips}, lanes {lanes}, one-lane {one}, p50 {out['p50_ms']:.2f} ms")
    return {**one, **lanes}, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tpch-scale", type=float, default=1.0,
                    help="TPC-H scale factor of the timed run on the card")
    ap.add_argument("--compare-with", metavar="DIR",
                    help="a checkout of another commit: time its kernels too, in turns "
                         "with this one's, on the same inputs")
    args = ap.parse_args()
    t_main = time.perf_counter()

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    name_power = card()
    print(name_power, flush=True)

    from baikaldb_tpu_torch.ops import group_kernels as gk

    before = None if args.compare_with is None else load_port(args.compare_with)
    phase_s = {}
    t0 = time.perf_counter()
    times = kernel_phase(gk, args.rows, args.seed, before)
    times["segment_reduce"] = segment_phase(args.rows, args.seed, before)
    wide_times = wide_phase(args.seed)
    phase_s["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table, refs = sql_table(args.rows, args.seed)
    launches, sql_stats, single = sql_phase(gk, table, refs)
    phase_s["sql"] = time.perf_counter() - t0
    # phase 15 (i) in phase 3's session; (ii) and (iii) ride phases 4 and 12
    t0 = time.perf_counter()
    observe: dict = {}
    observe["i_launches"], observe["i"] = observability_part(gk, single, refs)
    obs_s = time.perf_counter() - t0
    # phase 18 (i) in phase 3's session; the D references are phase 12's
    t0 = time.perf_counter()
    drefs = d_refs(table)
    drefs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire_launches, wire_lanes, wire_stats = wire_part(gk, single, refs, drefs, args.seed)
    phase18 = {"wire": wire_stats}
    wire_s = time.perf_counter() - t0
    # phase 19 (i) and (iii) in phase 3's session, resident as phase 3 ran
    t0 = time.perf_counter()
    p19, guard_launches = {}, {}
    with flag(single, "streaming_scan", 0):
        guard_launches["i"], p19["i"] = guard_part_i(gk, single, refs)
        guard_launches["iii"], p19["iii"] = guard_part_iii(gk, single, drefs, args.seed)
    guard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_launches, mesh_stats = mesh_sql_phase(gk, single, refs)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lane_counts, p12 = phase12(gk, single, table, args.seed, before, observe, drefs)
    del drefs
    # phase 15 (iii) ran in phase 12: its seconds count as observability's
    dispatch_s = time.perf_counter() - t0 - observe["iii"]["seconds"] + drefs_s
    t0 = time.perf_counter()
    part_launches, part_stats = partition_phase(gk, single, table)
    part_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    htap_launches, htap_stats = htap_snapshot_phase(gk, single, table, refs, args.seed)
    htap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lc_launches, lc_stats = lifecycle_phase(gk, single, table, args.seed)
    phase_s["lifecycle"] = time.perf_counter() - t0
    for checks in (htap_stats["kernel_checks"], part_stats["kernel_checks"],
                   lc_stats["kernel_checks"]):
        for k in REPLACES:
            err = checks["seg_max_abs_err" if k == "segment_reduce" else "k_max_abs_err"]
            times[k]["max_abs_err"] = max(times[k]["max_abs_err"], err)
    del single
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stream_launches, stream_stats = streamed_phase(gk, table, refs, observe)
    stream_stats["resident_peak_mem_gib"] = sql_stats["peak_mem_gib"]
    # phase 15 (ii) ran in this session: its seconds count as observability's
    phase_s["streamed"] = time.perf_counter() - t0 - observe["ii"]["seconds"]
    del table
    obs_launches = {k: sum(observe[f"{p}_launches"][k] for p in ("i", "ii", "iii"))
                    for k in REPLACES}
    obs_lanes = {k: observe["iii_lanes"][k] for k in LANE_KERNELS}
    obs_stats = {p: observe[p] for p in ("i", "ii", "iii")}
    phase_s["observability"] = obs_s + sum(observe[p]["seconds"] for p in ("ii", "iii"))
    for path, counts in (("resident", launches), ("streamed", stream_launches),
                         ("observability", obs_launches),
                         ("mesh", mesh_launches), ("versioned", htap_launches),
                         ("lane-batched", lane_counts), ("partitioned", part_launches),
                         ("lifecycle", {k: lc_launches[k] for k in LIFECYCLE_KERNELS}),
                         ("guarded", guard_launches["i"])):
        missing = [k for k, n in counts.items() if n == 0 and k != WIDE]
        if missing:
            raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check = tpch_card_vs_cpu(gk)
    phase_s["tpch_card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpch_stats, s, tables, first = tpch_on_the_card(gk, args.tpch_scale, args.seed)
    tpch_stats["streamed_at_check_scale"] = check[2]
    tpch_stats["wide_launches_at_check_scale"] = check[3]
    phase_s["tpch_timed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    analytic_stats = analytic_phase(gk, check, s, tables, args.tpch_scale)
    phase_s["analytics"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream_stats["tpch"] = tpch_streamed_vs_resident(s)
    phase_s["tpch_streamed_vs_resident"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_tpch_launches, mesh_stats["tpch"] = mesh_tpch_phase(gk, s)
    phase_s["mesh"] = mesh_s + time.perf_counter() - t0
    t0 = time.perf_counter()
    p12["cache"]["tpch"] = cache_tpch_phase(s)
    phase_s["dispatch"] = dispatch_s + time.perf_counter() - t0
    t0 = time.perf_counter()
    part_stats["match"] = match_phase(s, tables)
    part_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    p16 = {"presort": presort_part(s, first), "radix": radix_part(s, first)}
    p16_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from baikaldb_tpu_torch.models import tpch
    p19["ii"] = guard_part_ii(s, tpch.QUERIES)
    phase_s["guards"] = guard_s + time.perf_counter() - t0
    del first
    mesh_launches = {k: n + mesh_tpch_launches[k] for k, n in mesh_launches.items()}
    del s, tables
    t0 = time.perf_counter()
    egress_stats = egress_phase(check)
    phase_s["egress"] = time.perf_counter() - t0
    del check
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vector_launches, vector_stats = vector_phase(gk, args.seed)
    phase_s["vectors"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    htap_stats["row_engine"] = row_engine()
    sb_launches, htap_stats["sysbench"] = sysbench_phase(gk, args.seed)
    durable_launches, htap_stats["durable"] = durability_phase(gk, args.seed)
    phase_s["htap"] = htap_s + time.perf_counter() - t0
    htap_launches = {k: n + sb_launches[k] + durable_launches[k]
                     for k, n in htap_launches.items()}
    t0 = time.perf_counter()
    part_stats["global_index"] = global_index_phase(args.seed)
    part_stats["surface"] = surface_phase()
    phase_s["partitions"] = part_s + time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rep_launches, p16["replicated"] = replicated_phase(gk, args.seed)
    phase_s["replicated"] = p16_s + time.perf_counter() - t0
    missing = [k for k, n in rep_launches.items() if n == 0 and k != WIDE]
    if missing:
        raise AssertionError(f"kernels not launched on the replicated path: {missing}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cl_launches, p17 = cluster_phase(gk, args.seed)
    # phase 18 (ii) ran in phase 17: its seconds count as phase 18's
    phase18["frontend"] = p17.pop("frontend")
    phase_s["cluster"] = time.perf_counter() - t0 - phase18["frontend"]["seconds"]
    missing = [k for k, n in cl_launches.items() if n == 0 and k != WIDE]
    if missing:
        raise AssertionError(f"kernels not launched on the cluster path: {missing}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chaos_launches, chaos_lanes, phase18["chaos"] = chaos_part(gk, args.seed)
    phase_s["wire"] = wire_s + phase18["frontend"]["seconds"] + time.perf_counter() - t0
    for k in REPLACES:
        for checks in (p16["replicated"]["kernel_checks"], p17["kernel_checks"]):
            err = checks["seg_max_abs_err" if k == "segment_reduce" else "k_max_abs_err"]
            times[k]["max_abs_err"] = max(times[k]["max_abs_err"], err)
    print(f"htap phase seconds: {phase_s['htap']:.1f}", flush=True)
    print(f"analytic phase seconds: {phase_s['analytics']:.1f}", flush=True)
    print(f"vector phase seconds: {phase_s['vectors']:.1f}", flush=True)
    print(f"mesh phase seconds: {phase_s['mesh']:.1f}", flush=True)
    print(f"dispatch phase seconds: {phase_s['dispatch']:.1f}", flush=True)
    print(f"partition phase seconds: {phase_s['partitions']:.1f}", flush=True)
    print(f"lifecycle phase seconds: {phase_s['lifecycle']:.1f}", flush=True)
    print(f"observability phase seconds: {phase_s['observability']:.1f}", flush=True)
    print(f"replicated phase seconds: {phase_s['replicated']:.1f}", flush=True)
    print(f"cluster phase seconds: {phase_s['cluster']:.1f}", flush=True)
    print(f"wire phase seconds: {phase_s['wire']:.1f}", flush=True)
    print(f"guards phase seconds: {phase_s['guards']:.1f}", flush=True)
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    script_s = time.perf_counter() - t_main
    print(f"script seconds: {script_s:.1f} (phases {sum(phase_s.values()):.1f}, builds "
          f"included)", flush=True)

    kernels = [{"name": k, "route": "cuda",
                "source": SOURCES.get(k, "baikaldb_tpu_torch/ops/csrc/group_agg.cu"),
                "replaces": REPLACES[k],
                "launches": (launches[k] + stream_launches.get(k, 0) + vector_launches[k]
                             + mesh_launches[k] + htap_launches[k] + part_launches[k]
                             + lc_launches[k] + obs_launches[k] + rep_launches[k]
                             + cl_launches[k] + wire_launches[k] + chaos_launches[k]
                             + guard_launches["i"][k] + guard_launches["iii"].get(k, 0)),
                "launches_resident": launches[k],
                "launches_streamed": stream_launches.get(k, 0),
                "launches_vectors": vector_launches[k],
                "launches_mesh": mesh_launches[k],
                "launches_htap": htap_launches[k],
                "launches_partitioned": part_launches[k],
                "launches_lifecycle": lc_launches[k],
                "launches_observability": obs_launches[k],
                "launches_replicated": rep_launches[k],
                "launches_cluster": cl_launches[k],
                "launches_wire": wire_launches[k],
                "launches_chaos": chaos_launches[k],
                "launches_guards": guard_launches["i"][k] + guard_launches["iii"].get(k, 0),
                **times[k],
                # this kernel on phase 13's pruned batch and on phase 14's
                # refreshed table
                "pruned": part_stats["kernel_checks"]["kernels"][k],
                "lifecycle": lc_stats["kernel_checks"]["kernels"][k],
                # and on phase 16 (ii)'s table rebuilt from its replicas, and
                # on phase 17's image pulled from the TCP cluster
                "replicated": p16["replicated"]["kernel_checks"]["kernels"][k],
                "cluster": p17["kernel_checks"]["kernels"][k]}
               for k in REPLACES]
    # the lane-batched entries (phase 12): timed at --rows rows over 8 lanes
    lane_times = p12["kernels"][f"n{args.rows}_G8"]
    kernels += [{"name": k, "route": "cuda",
                 "source": SOURCES.get(k, "baikaldb_tpu_torch/ops/csrc/group_agg.cu"),
                 "replaces": REPLACES[base], "launches": lane_counts[k],
                 "launches_lifecycle": lc_stats["lane_launches"][k],
                 "launches_observability": obs_lanes[k],
                 "launches_wire": wire_lanes[k],
                 "launches_chaos": chaos_lanes[k],
                 "launches_guards": guard_launches["iii"].get(k, 0),
                 "max_abs_err": p12["kernels"]["max_abs_err"], **lane_times[k]}
                for k, base in LANE_KERNELS.items()]
    # the wide dense GROUP BY kernel: timed in phase 2 (q10's shape at the
    # top level, both in ``shapes``); launches by path, TPC-H's at the check
    # scale and over the timed run's first runs
    wide_paths = {p: n.get(WIDE, 0) for p, n in (
        ("resident", launches), ("streamed", stream_launches), ("vectors", vector_launches),
        ("mesh", mesh_launches), ("htap", htap_launches), ("partitioned", part_launches),
        ("lifecycle", lc_launches), ("replicated", rep_launches), ("cluster", cl_launches),
        ("wire", wire_launches), ("chaos", chaos_launches), ("guards", guard_launches["i"]))}
    wide_paths["guards"] += guard_launches["iii"].get(WIDE, 0)
    wide_paths["tpch_check"] = tpch_stats["wide_launches_at_check_scale"]
    wide_paths["tpch"] = tpch_stats["wide_launches"]
    kernels.append({"name": WIDE, "route": "cuda",
                    "source": "baikaldb_tpu_torch/ops/csrc/dense_agg.cu",
                    "replaces": "baikaldb_tpu/ops/hashagg.py:358 (_segment_one's scatters)",
                    "launches": sum(wide_paths.values()),
                    **{f"launches_{p}": n for p, n in wide_paths.items()},
                    **wide_times["q10"], "shapes": wide_times})
    print(json.dumps({"card": name_power, "rows": args.rows, "phase_s": phase_s,
                      "script_s": script_s,
                      "sql": sql_stats, "streamed": stream_stats, "tpch": tpch_stats,
                      "analytics": analytic_stats, "egress": egress_stats,
                      "vectors": vector_stats, "mesh": mesh_stats, "htap": htap_stats,
                      "dispatch": p12, "partitions": part_stats, "lifecycle": lc_stats,
                      "observability": obs_stats, "phase16": p16, "phase17": p17,
                      "phase18": phase18, "phase19": p19}),
          flush=True)
    print(name_power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
