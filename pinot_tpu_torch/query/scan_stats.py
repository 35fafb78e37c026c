"""Scan-path attribution: which access path served each filter predicate.

The engine executes a segment through one of three modes (fused device
program, host fallback, star-tree swap) but until now recorded nothing about
*how* each predicate was satisfied — a dictionary-sorted binary search, an
inverted-index posting intersection, or a full column scan all looked the
same from the outside.  This module classifies every filter leaf against the
segment's index metadata and the execution mode, yielding per-predicate
``(column, path, entries)`` rows that fold upward into:

- Pinot-parity response metadata (``numEntriesScannedInFilter`` /
  ``numEntriesScannedPostFilter``),
- ``server.scan.*{table=,index=}`` meters,
- slow-query-log ``scanProfile`` entries,
- EXPLAIN filter-plan lines (``FILTER_INVERTED_INDEX(col)``), and
- the full-scan-fallback offender signal (a predicate that fell back to
  ``FULL_SCAN`` even though the segment declares a usable index for it).

Entry-count semantics follow Pinot: an index-served predicate scans zero
entries in the filter phase (the index answers from its own structure), a
``FULL_SCAN`` predicate examines every doc's value (``n_docs`` entries), and
the post-filter phase scans ``docsMatched x projectedColumns`` entries.
These definitions are deliberately recountable from first principles so
tests can verify attribution against a brute-force recount.

Index *probe* hooks (``record_index_probe``) let the index structures
themselves report how many internal entries a lookup examined (posting-list
lengths, HNSW hops, grid cells).  They ride a contextvar collector and cost
one contextvar read + None check when nobody is collecting, so the
disabled path stays off the hot-path budget.

The JAX package's `query/scan_stats.py`. Until the port's segments carry aux
indexes, a leaf is SORTED_INDEX on a sorted dictionary column, NULL_INDEX
for IS [NOT] NULL over a column with a null vector, STARTREE_INDEX under
the star-tree swap, and FULL_SCAN otherwise, as in the reference for such a
segment.
"""

from __future__ import annotations

from pinot_tpu_torch.common.scan_probe import collect_probes, record_index_probe
from pinot_tpu_torch.query import ast as qast
from pinot_tpu_torch.query.ast import CompareOp

__all__ = ["collect_probes", "record_index_probe"]  # re-exported hook surface

# Access-path names (EXPLAIN renders them as FILTER_<PATH>(col)).
SORTED_INDEX = "SORTED_INDEX"
INVERTED_INDEX = "INVERTED_INDEX"
RANGE_INDEX = "RANGE_INDEX"
FST_INDEX = "FST_INDEX"
NULL_INDEX = "NULL_INDEX"
TEXT_INDEX = "TEXT_INDEX"
JSON_INDEX = "JSON_INDEX"
VECTOR_INDEX = "VECTOR_INDEX"
GEO_INDEX = "GEO_INDEX"
STARTREE_INDEX = "STARTREE_INDEX"
FULL_SCAN = "FULL_SCAN"

ALL_PATHS = frozenset(
    {
        SORTED_INDEX,
        INVERTED_INDEX,
        RANGE_INDEX,
        FST_INDEX,
        NULL_INDEX,
        TEXT_INDEX,
        JSON_INDEX,
        VECTOR_INDEX,
        GEO_INDEX,
        STARTREE_INDEX,
        FULL_SCAN,
    }
)

_EQ_OPS = (CompareOp.EQ, CompareOp.NEQ)

# -- process-wide enable switch (ObservabilityConfig.scanObsEnabled) ----------

_ENABLED = True


def configure(enabled: bool) -> None:
    global _ENABLED
    _ENABLED = bool(enabled)


def enabled() -> bool:
    return _ENABLED


# -- predicate classification -------------------------------------------------


def filter_leaves(f) -> list:
    """Flatten a filter tree into its predicate leaves (And/Or/Not are
    connective structure, not access paths)."""
    if f is None:
        return []
    if isinstance(f, qast.And) or isinstance(f, qast.Or):
        out = []
        for c in f.children:
            out.extend(filter_leaves(c))
        return out
    if isinstance(f, qast.Not):
        return filter_leaves(f.child)
    return [f]


def _leaf_column(leaf) -> str:
    if isinstance(leaf, qast.Compare):
        if isinstance(leaf.left, qast.Identifier):
            return leaf.left.name
        if isinstance(leaf.right, qast.Identifier):
            return leaf.right.name
    for attr in ("expr", "left"):
        node = getattr(leaf, attr, None)
        if isinstance(node, qast.Identifier):
            return node.name
    if isinstance(leaf, qast.PredicateFunction) and leaf.args:
        if (
            leaf.name == "st_within_distance"
            and len(leaf.args) >= 2
            and isinstance(leaf.args[0], qast.Identifier)
            and isinstance(leaf.args[1], qast.Identifier)
        ):
            return f"{leaf.args[0].name},{leaf.args[1].name}"
        if isinstance(leaf.args[0], qast.Identifier):
            return leaf.args[0].name
    return "?"


def _is_range_shaped(leaf) -> bool:
    return isinstance(leaf, qast.Between) or (
        isinstance(leaf, qast.Compare) and leaf.op not in _EQ_OPS
    )


def _sorted_dict_col(seg, col: str) -> bool:
    ci = seg.columns.get(col)
    if ci is None or not ci.is_dict_encoded or ci.is_mv:
        return False
    st = getattr(ci, "stats", None)
    return bool(st is not None and getattr(st, "is_sorted", False))


def _declared_index(leaf, col: str, seg) -> str | None:
    """The index class the segment *declares* for this predicate shape, mode
    aside — the path a perfect planner would pick.  None when only a full
    scan could ever serve it."""
    ex = seg.extras or {}
    if isinstance(leaf, qast.PredicateFunction):
        name = leaf.name.lower()
        if name == "text_match" and col in (ex.get("text") or {}):
            return TEXT_INDEX
        if name == "json_match" and col in (ex.get("json") or {}):
            return JSON_INDEX
        if name == "vector_similarity" and col in (ex.get("vector") or {}):
            return VECTOR_INDEX
        if name == "st_within_distance" and col in (ex.get("geo") or {}):
            return GEO_INDEX
        return None
    if isinstance(leaf, (qast.Like, qast.RegexpLike)):
        return FST_INDEX if col in (ex.get("fst") or {}) else None
    if isinstance(leaf, qast.IsNull):
        return NULL_INDEX if col in (ex.get("null") or {}) else None
    if _is_range_shaped(leaf):
        if _sorted_dict_col(seg, col):
            return SORTED_INDEX
        if col in (ex.get("range") or {}):
            return RANGE_INDEX
        return None
    if isinstance(leaf, (qast.Compare, qast.In)):
        if _sorted_dict_col(seg, col):
            return SORTED_INDEX
        if col in (ex.get("inverted") or {}):
            return INVERTED_INDEX
        return None
    return None


def classify_leaf(leaf, seg, mode: str) -> tuple[str, str, int]:
    """-> (column, access path, entries scanned in filter for this leaf).

    `mode` is how the segment actually executed: "device" (fused program —
    dictionary/sorted/inverted/range structures are live), "host" (python
    fallback — column predicates scan the forward column; only the
    special-function and fst/null probes reach an index), or "startree"
    (every leaf answered from the pre-aggregated star-tree).
    """
    col = _leaf_column(leaf)
    if mode == "startree":
        return col, STARTREE_INDEX, 0
    declared = _declared_index(leaf, col, seg)
    if declared is None:
        return col, FULL_SCAN, int(seg.n_docs)
    if mode == "host" and declared in (SORTED_INDEX, INVERTED_INDEX, RANGE_INDEX):
        # the host executor evaluates plain column predicates against the
        # forward column — the declared structure exists but is not used.
        return col, FULL_SCAN, int(seg.n_docs)
    return col, declared, 0


def segment_scan_stats(ctx, seg, mode: str, matched: int, n_post_cols: int) -> dict:
    """Classify every filter leaf of `ctx` against `seg` as executed via
    `mode`; returns the per-segment scan record the engine folds upward."""
    preds = []
    entries_in = 0
    fallbacks = []
    for leaf in filter_leaves(ctx.filter):
        col, path, entries = classify_leaf(leaf, seg, mode)
        entries_in += entries
        preds.append({"column": col, "path": path, "entries": entries})
        if path == FULL_SCAN:
            declared = _declared_index(leaf, col, seg)
            if declared is not None:
                fallbacks.append({"column": col, "missedIndex": declared})
    return {
        "segment": seg.name,
        "mode": mode,
        "predicates": preds,
        "entriesInFilter": entries_in,
        "entriesPostFilter": int(matched) * int(n_post_cols),
        "docsMatched": int(matched),
        "fullScanFallbacks": fallbacks,
    }


# -- query-level accumulation (wire form) -------------------------------------


def new_scan_summary() -> dict:
    """The per-query scan summary in its wire form: plain dict of ints /
    string-keyed int maps, so it rides the datatable codec and JSON as-is."""
    return {
        "entriesInFilter": 0,
        "entriesPostFilter": 0,
        # "col:PATH" -> predicate evaluation count (per segment execution)
        "predicates": {},
        # "col:PATH" -> filter-phase entries examined by that predicate
        "predicateEntries": {},
        # column -> missed-index fallback count
        "fullScanFallbacks": {},
        # prune reason -> segments pruned ("value" | "bloom" | "geo")
        "prunedByReason": {},
        # index kind -> internal entries examined (probe hooks)
        "indexProbeEntries": {},
    }


def fold_segment_stats(summary: dict, seg_stats: dict) -> None:
    summary["entriesInFilter"] += seg_stats["entriesInFilter"]
    summary["entriesPostFilter"] += seg_stats["entriesPostFilter"]
    preds = summary["predicates"]
    entries = summary["predicateEntries"]
    for p in seg_stats["predicates"]:
        key = f"{p['column']}:{p['path']}"
        preds[key] = preds.get(key, 0) + 1
        entries[key] = entries.get(key, 0) + p["entries"]
    fb = summary["fullScanFallbacks"]
    for f in seg_stats["fullScanFallbacks"]:
        fb[f["column"]] = fb.get(f["column"], 0) + 1


def fold_prune(summary: dict, reason: str) -> None:
    pr = summary["prunedByReason"]
    pr[reason] = pr.get(reason, 0) + 1


def merge_probe_sink(summary: dict, probes: dict | None) -> None:
    """Fold a dispatch-time probe sink (bloom/geo lookups made while
    pruning) into a query summary's indexProbeEntries."""
    if not probes:
        return
    dst = summary["indexProbeEntries"]
    for k, v in probes.items():
        dst[k] = dst.get(k, 0) + int(v)


def merge_scan_summaries(into: dict, other: dict | None) -> dict:
    """Sum `other` into `into` (broker reduce across scatter partials; the
    hedged path merges only the winning leg's summary)."""
    if not other:
        return into
    into["entriesInFilter"] += int(other.get("entriesInFilter") or 0)
    into["entriesPostFilter"] += int(other.get("entriesPostFilter") or 0)
    for field in (
        "predicates",
        "predicateEntries",
        "fullScanFallbacks",
        "prunedByReason",
        "indexProbeEntries",
    ):
        dst = into[field]
        for k, v in (other.get(field) or {}).items():
            dst[k] = dst.get(k, 0) + int(v)
    return into
