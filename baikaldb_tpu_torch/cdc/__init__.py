"""CDC: change streams over the durable binlog + incrementally maintained
rollup views (the baikal_capturer SDK / region_olap rollup pairing); the
port of ``baikaldb_tpu/cdc``.

- :mod:`.streams` — SUBSCRIBE-style durable cursors: named, resumable
  (resume token = last acked commit_ts), k-way commit_ts merge across
  feeds, GC holds behind the slowest active cursor, typed CursorLagging
  on force-expiry.
- :mod:`.views` — ``CREATE MATERIALIZED VIEW ... GROUP BY`` state folded
  incrementally from the view's change stream through the mergeable
  partial-aggregate layout (cnt/sum/min/max per measure), answered by the
  planner via the rollup rewrite onto a hidden ``__mv_*`` table.
"""

from .streams import (ChangeStreams, CursorLagging, Subscription,  # noqa
                      merge_by_commit_ts)
from .views import MV_PREFIX, MatView, MatViews, is_mv_table  # noqa
