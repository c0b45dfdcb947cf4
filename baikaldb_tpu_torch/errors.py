"""Errors shared across the port."""

from __future__ import annotations


class NotPortedError(NotImplementedError):
    """A feature of the JAX package that this port does not carry yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported yet (baikaldb_tpu_torch "
                         "runs SELECT with joins, subqueries and GROUP BY; "
                         "see ROADMAP.md for the queue)")
