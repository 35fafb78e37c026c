"""Multi-tenancy + tiered storage.

Reference parity:
- Tenants: servers/brokers carry tenant tags ("<tenant>_OFFLINE",
  "<tenant>_REALTIME", "<tenant>_BROKER"); tables declare a broker and a
  server tenant, and segment assignment / query routing never cross tenant
  boundaries (PinotHelixResourceManager tenant APIs, pinot-controller/.../
  helix/core/PinotHelixResourceManager.java:192; TagNameUtils).
- Tiers: tierConfigs select segments (time-based age) onto servers carrying
  the tier's tag; the rebalancer relocates matching segments
  (TierBasedSegmentDirectoryLoader, pinot-segment-local/.../loader/
  TierBasedSegmentDirectoryLoader.java:40; TierSegmentSelector).

Table config carries both under `extra`:
    extra["tenants"] = {"broker": "tenantA", "server": "tenantA"}
    extra["tierConfigs"] = [
        {"name": "cold", "segmentAgeSeconds": 604800, "serverTag": "cold_tier"},
        ...
    ]  # first matching tier wins; unmatched segments use the server tenant
"""

from __future__ import annotations

import time

DEFAULT_TENANT = "DefaultTenant"


def server_tag(tenant: str, table_type) -> str:
    return f"{tenant}_{getattr(table_type, 'value', table_type)}"


def broker_tag(tenant: str) -> str:
    return f"{tenant}_BROKER"


def table_tenants(config) -> tuple[str, str]:
    """(broker tenant, server tenant) with DefaultTenant fallback."""
    t = (config.extra or {}).get("tenants") or {}
    return t.get("broker", DEFAULT_TENANT), t.get("server", DEFAULT_TENANT)


def tagged_servers(controller, tag: str) -> list[str]:
    """Server ids whose instance doc carries `tag`. Untagged servers are
    implicit members of the DefaultTenant (bootstrap-friendly, matching the
    reference's untagged -> DefaultTenant initial state)."""
    out = []
    for path in controller.store.list("/instances/"):
        sid = path.split("/")[-1]
        doc = controller.store.get(path) or {}
        tags = doc.get("tags") or []
        if tag in tags or (not tags and tag.startswith(DEFAULT_TENANT + "_")):
            out.append(sid)
    return sorted(out)


def candidate_servers(controller, config) -> list[str]:
    """Servers eligible to host a table's segments (its server tenant)."""
    _, srv_tenant = table_tenants(config)
    tag = server_tag(srv_tenant, config.table_type)
    cands = tagged_servers(controller, tag)
    if not cands:
        raise RuntimeError(
            f"no servers tagged {tag!r} for table {config.table_name!r} "
            f"(tenant {srv_tenant!r})"
        )
    return cands


def tier_of_segment(config, seg_meta: dict, now: float | None = None) -> dict | None:
    """First tier whose age selector matches, else None (stay on the
    tenant's default servers). Age is measured from the segment's upload
    time (TimeBasedTierSegmentSelector uses segment end time; uploadedAt is
    this framework's closest committed-time analog)."""
    tiers = (config.extra or {}).get("tierConfigs") or []
    if not tiers:
        return None
    now = time.time() if now is None else now
    uploaded = seg_meta.get("uploadedAt")
    if uploaded is None:
        return None
    age = now - float(uploaded)
    # Oldest-age tier first (TierConfigUtils.getTierComparator sorts
    # time-based selectors before first-match) — raw config order would
    # route every aged segment to whichever tier happens to be listed
    # first, never the colder ones.
    ordered = sorted(tiers, key=lambda t: -float(t.get("segmentAgeSeconds", 0)))
    for tier in ordered:
        if age >= float(tier.get("segmentAgeSeconds", 0)):
            return tier
    return None
