"""User accounts + grants (reference: src/meta_server/privilege_manager.cpp
holds users/passwords/db+table privileges raft-replicated; the frontend
enforces them per statement).  Copied from ``baikaldb_tpu/meta/privileges.py``
(host-only Python); the session consults it per statement.

Password storage is MySQL's mysql_native_password scheme: the server keeps
SHA1(SHA1(password)) (the ``authentication_string``), and the wire check
XORs the client's response with SHA1(salt + stored) to recover
SHA1(password), which must re-hash to the stored value — the password never
crosses the wire.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Optional

READ, WRITE = "read", "write"
_LEVELS = {"select": READ, "read": READ, "all": WRITE, "write": WRITE}


class AccessError(RuntimeError):
    """MySQL ER_ACCESS_DENIED / ER_DBACCESS_DENIED family."""


def _sha1(b: bytes) -> bytes:
    return hashlib.sha1(b).digest()


def mysql_native_hash(password: str) -> bytes:
    """-> stored authentication string SHA1(SHA1(password))."""
    return _sha1(_sha1(password.encode()))


def scramble_check(stored: bytes, salt: bytes, response: bytes) -> bool:
    """Verify a mysql_native_password auth response against the stored
    double-SHA1 (protocol: response = SHA1(pw) XOR SHA1(salt + stored))."""
    if len(response) != 20:
        return False
    mask = _sha1(salt + stored)
    sha_pw = bytes(a ^ b for a, b in zip(response, mask))
    return _sha1(sha_pw) == stored


@dataclass
class UserInfo:
    name: str
    auth: Optional[bytes] = None        # None = passwordless
    # db name (or "*") -> "read" | "write"
    grants: dict = field(default_factory=dict)
    is_super: bool = False


class PrivilegeManager:
    """In-process privilege catalog; the server authenticates against it and
    sessions consult it per statement."""

    def __init__(self):
        self._mu = threading.Lock()
        self.users: dict[str, UserInfo] = {
            # bootstrap superuser, passwordless (MySQL's initial root)
            "root": UserInfo("root", None, {"*": WRITE}, is_super=True),
        }

    # -- admin ------------------------------------------------------------
    def create_user(self, name: str, password: str = "",
                    if_not_exists: bool = False):
        with self._mu:
            if name in self.users:
                if if_not_exists:
                    return
                raise AccessError(f"user {name!r} already exists")
            auth = mysql_native_hash(password) if password else None
            self.users[name] = UserInfo(name, auth)

    def drop_user(self, name: str, if_exists: bool = False):
        with self._mu:
            if name == "root":
                raise AccessError("cannot drop root")
            if name not in self.users and not if_exists:
                raise AccessError(f"unknown user {name!r}")
            self.users.pop(name, None)

    def grant(self, name: str, level: str, db: str = "*"):
        lv = _LEVELS.get(level.lower())
        if lv is None:
            raise AccessError(f"unknown privilege level {level!r}")
        with self._mu:
            u = self.users.get(name)
            if u is None:
                raise AccessError(f"unknown user {name!r}")
            cur = u.grants.get(db)
            u.grants[db] = WRITE if WRITE in (cur, lv) else lv

    def revoke(self, name: str, db: str = "*"):
        with self._mu:
            u = self.users.get(name)
            if u is None:
                raise AccessError(f"unknown user {name!r}")
            u.grants.pop(db, None)

    # -- checks -----------------------------------------------------------
    # (the read paths hold _mu too: grant/revoke mutate UserInfo.grants
    # in place, so a lockless reader could see a half-applied grant)
    def authenticate(self, name: str, salt: bytes, response: bytes) -> bool:
        with self._mu:
            u = self.users.get(name)
            if u is None:
                return False
            if u.auth is None:
                return len(response) == 0
            return scramble_check(u.auth, salt, response)

    def check(self, name: str, db: str, need: str):
        """Raise unless ``name`` holds ``need`` ("read"|"write") on ``db``."""
        with self._mu:
            u = self.users.get(name)
            if u is None:
                raise AccessError(f"Access denied for user {name!r}")
            if u.is_super or db == "information_schema" and need == READ:
                return
            lv = u.grants.get(db) or u.grants.get("*")
        if lv is None or (need == WRITE and lv != WRITE):
            raise AccessError(f"Access denied for user {name!r} to "
                              f"database {db!r}")

    def grants_of(self, name: str) -> list[tuple[str, str]]:
        with self._mu:
            u = self.users.get(name)
            if u is None:
                return []
            if u.is_super:
                return [("*", "ALL")]
            return sorted((db, "ALL" if lv == WRITE else "SELECT")
                          for db, lv in u.grants.items())
