"""Observability: query-lifecycle tracing (trace.py), live progress and
KILL (progress.py), the flight recorder (flightrec.py), the query watchdog
(watchdog.py) and the local telemetry plane (telemetry.py)."""
