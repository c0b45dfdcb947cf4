"""MySQL error-code catalog (reference: mysql_err_handler.cpp's 935-line
code/message table).  Maps engine exceptions onto the MySQL errno + SQLSTATE
a client-side connector or ORM expects to switch on.

A copy of ``baikaldb_tpu/server/errors.py`` over the port's exception types.
The message patterns hold because the port's error texts are the JAX
package's: a failing statement gets the same errno and SQLSTATE from either
server (``tests/test_torch_server.py`` holds them equal)."""

from __future__ import annotations

import re

from ..meta.privileges import AccessError
from ..obs.progress import QueryKilled
from ..sql.lexer import SqlError
from ..storage.rowstore import ConflictError

# (pattern, errno, sqlstate) — first match wins
_PATTERNS = [
    (r"Query execution was interrupted", 1317, "70100"),
    (r"Unknown thread id", 1094, "HY000"),
    (r"Duplicate entry", 1062, "23000"),
    (r"locked by", 1205, "HY000"),
    (r"Lock wait", 1205, "HY000"),
    (r"unknown database", 1049, "42000"),
    (r"unknown table", 1146, "42S02"),
    (r"no such table", 1146, "42S02"),
    (r"table .* does not exist", 1146, "42S02"),
    (r"unknown column", 1054, "42S22"),
    (r"ambiguous column", 1052, "23000"),
    (r"Subquery returns more than 1 row", 1242, "21000"),
    (r"Access denied", 1045, "28000"),
    (r"requires SUPER", 1227, "42000"),
    (r"Duplicate (table|database)|already exists", 1050, "42S01"),
    (r"division by zero", 1365, "22012"),
    (r"GROUP BY", 1055, "42000"),
    (r"rejected by QoS|admission", 1041, "08004"),
    (r"unknown function", 1305, "42000"),
    (r"unsupported statement|unexpected token|expected ", 1064, "42000"),
]


def errno_for(exc: BaseException) -> tuple[int, str]:
    """-> (errno, sqlstate) for an engine exception."""
    msg = str(exc)
    if isinstance(exc, QueryKilled):
        return 1317, "70100"               # ER_QUERY_INTERRUPTED
    if isinstance(exc, AccessError):
        return (1227, "42000") if "SUPER" in msg else (1045, "28000")
    if isinstance(exc, ConflictError):
        return (1062, "23000") if "Duplicate" in msg else (1205, "HY000")
    for pat, code, state in _PATTERNS:
        if re.search(pat, msg, re.I):
            return code, state
    if isinstance(exc, SqlError):
        return 1064, "42000"
    return 1105, "HY000"       # ER_UNKNOWN_ERROR
