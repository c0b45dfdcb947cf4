"""95th percentile of the latencies of every statement sent inside the
window, not a median of chunks (host clock, from the SQL text handed to
``Session.execute`` to the rows on the host; a statement still out at the
close counts with its whole wait)."""

from gpubench.core.stats import percentile


def read(run):
    lat = [(r.done - r.sent) * 1e3 for r in run.records if not r.error]
    return percentile(lat, 95) if lat else None
