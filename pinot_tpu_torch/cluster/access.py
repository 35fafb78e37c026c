"""Access control for broker and controller APIs.

Reference parity: pinot-controller/src/main/java/org/apache/pinot/
controller/api/access/ — the AccessControl / AccessControlFactory SPI
(hasAccess(tableName, accessType, httpHeaders, endpointUrl)) with the
shipped implementations AllowAllAccessFactory and BasicAuthAccessControl
(pinot-core/.../auth/BasicAuthAccessControlFactory), plus the broker's
AccessControl check in BaseBrokerRequestHandler.handleRequest.

Model: principals are (user, password/token) with a table allowlist and a
permission set {READ, WRITE}. Identity arrives as an HTTP Basic
`Authorization` header (or a pre-parsed token); `has_access` gates every
query (READ on the table) and every mutating controller call (WRITE).

This is the JAX package's `cluster/access.py`; it has no device part.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field

READ = "READ"
WRITE = "WRITE"


class AccessDenied(PermissionError):
    """401/403 analog raised by guarded endpoints."""


@dataclass
class Principal:
    user: str
    token: str  # password (basic auth) or bearer token
    tables: tuple = ("*",)  # allowlisted tables; "*" = all
    permissions: tuple = (READ, WRITE)

    def allows(self, table: str | None, access: str) -> bool:
        if access not in self.permissions:
            return False
        if table is None or "*" in self.tables:
            return True
        return table in self.tables


class AccessControl:
    """SPI: override has_access. The default allows everything
    (AllowAllAccessFactory parity — auth is opt-in)."""

    def has_access(self, identity: str | None, table: str | None, access: str) -> bool:
        return True

    def authenticate(self, headers: dict) -> str | None:
        """Extract an identity from HTTP-style headers; None = anonymous."""
        return None

    # convenience guard shared by the broker / controller call sites
    def check(self, identity: str | None, table: str | None, access: str) -> None:
        if not self.has_access(identity, table, access):
            raise AccessDenied(
                f"{access} access to table {table!r} denied for {identity or 'anonymous'!r}"
            )


class AllowAllAccessControl(AccessControl):
    pass


@dataclass
class BasicAuthAccessControl(AccessControl):
    """Static basic-auth principals (BasicAuthAccessControlFactory parity).
    Unauthenticated requests are denied outright."""

    principals: list = field(default_factory=list)

    def _find(self, identity: str | None) -> "Principal | None":
        if not identity:
            return None
        for p in self.principals:
            if f"{p.user}:{p.token}" == identity:
                return p
        return None

    def authenticate(self, headers: dict) -> str | None:
        auth = None
        for k, v in headers.items():
            if k.lower() == "authorization":
                auth = v
                break
        if not auth:
            return None
        if auth.startswith("Basic "):
            try:
                return base64.b64decode(auth[6:]).decode()
            except Exception:  # pinotlint: disable=deadline-swallow — garbled auth header means anonymous; no query runs inside this try
                return None
        if auth.startswith("Bearer "):
            # token-only principals use user "": identity "user:token" form
            tok = auth[7:]
            for p in self.principals:
                if p.token == tok:
                    return f"{p.user}:{p.token}"
            return None
        return None

    def has_access(self, identity: str | None, table: str | None, access: str) -> bool:
        p = self._find(identity)
        return p is not None and p.allows(table, access)


def parse_basic(user: str, password: str) -> str:
    """Client-side helper: the identity string a (user, password) pair maps
    to — pass as `identity=` on the in-process APIs, or send the equivalent
    `Authorization: Basic ...` header over HTTP."""
    return f"{user}:{password}"
