"""Multistage planner rule framework.

Reference parity: the Calcite rule tier the reference planner runs between
parse and physical planning — ~40 rule classes under
pinot-query-planner/src/main/java/org/apache/pinot/calcite/rel/rules/
(PinotFilterIntoScanRule, PinotAggregateExchangeNodeInsertRule,
PinotSortExchangeCopyRule, ...) driven by Calcite's HepPlanner fixpoint.

This is the same architecture, sized to this planner's node model: a Rule is
(name, matches, apply); `optimize` runs a rule set bottom-up to fixpoint and
records per-rule hit counts, which ride into the StagePlan for EXPLAIN.
`LOGICAL_RULES` run before exchange placement; `PHYSICAL_RULES` after, over
the exchange-annotated tree.

The builder already does a first pushdown pass inline at build time; the
rules re-establish those invariants over shapes the builder can't see in
one pass (filters emerging above joins/projects after subquery flattening,
double exchanges from composed operators, sort+limit above a singleton
exchange) — the HepPlanner "keep firing until nothing changes" model.

This is the JAX package's `multistage/rules.py`, unchanged but for its
imports, which point at the port's modules.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Callable

from pinot_tpu_torch.multistage import logical as L
from pinot_tpu_torch.multistage.logical import (
    Exchange,
    FilterNode,
    Node,
    Project,
    Scan,
    Sort,
    _and_all,
    _conjuncts,
    _filter_resolves,
    _push_filter,
    _strip_qualifiers,
)
from pinot_tpu_torch.query import ast


@dataclass(frozen=True)
class Rule:
    """One rewrite: apply(node) returns a REPLACEMENT node or None for no
    match. Structural mutation of children is allowed (the tree is
    planner-private)."""

    name: str
    apply: Callable[[Node], "Node | None"]


def _children(node: Node) -> list[tuple[str, Node]]:
    out = []
    for attr in ("input", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, Node):
            out.append((attr, child))
    return out


def optimize(root: Node, rules: list[Rule], stats: dict[str, int], max_passes: int = 10) -> Node:
    """Bottom-up fixpoint driver (HepPlanner analog). Each pass rewrites the
    whole tree once; passes repeat until no rule fires or max_passes."""

    def rewrite(node: Node) -> tuple[Node, bool]:
        changed = False
        for attr, child in _children(node):
            new, c = rewrite(child)
            if c:
                setattr(node, attr, new)
                changed = True
        for rule in rules:
            replacement = rule.apply(node)
            if replacement is not None:
                stats[rule.name] = stats.get(rule.name, 0) + 1
                return replacement, True
        return node, changed

    for _ in range(max_passes):
        root, changed = rewrite(root)
        if not changed:
            break
    return root


# ---------------------------------------------------------------------------
# logical rules
# ---------------------------------------------------------------------------


def _filter_merge(node: Node) -> Node | None:
    """Filter(Filter(x)) -> Filter(x, a AND b)  [FilterMergeRule]."""
    if isinstance(node, FilterNode) and isinstance(node.input, FilterNode):
        inner = node.input
        return FilterNode(inner.input, _and_all(_conjuncts(inner.condition) + _conjuncts(node.condition)))
    return None


def _fold_compare(c: ast.FilterExpr) -> "bool | None":
    """Literal-literal comparison -> its truth value, else None."""
    if (
        isinstance(c, ast.Compare)
        and isinstance(c.left, ast.Literal)
        and isinstance(c.right, ast.Literal)
    ):
        try:
            l, r = c.left.value, c.right.value
            return {
                "EQ": l == r,
                "NEQ": l != r,
                "LT": l < r,
                "LTE": l <= r,
                "GT": l > r,
                "GTE": l >= r,
            }[c.op.name]
        except Exception:  # pinotlint: disable=deadline-swallow — constant-fold probe at plan time; None means 'not foldable'
            return None
    return None


def _constant_fold_filter(node: Node) -> Node | None:
    """Drop always-true conjuncts; drop the Filter entirely when everything
    folds to TRUE [ReduceExpressionsRule slice: literal comparisons only —
    a FALSE conjunct is left in place, the runtime evaluates it]. Also folds
    inside Scan.filter, where the builder's inline pushdown may already have
    parked the predicate."""
    if isinstance(node, Scan) and node.filter is not None:
        cs = _conjuncts(node.filter)
        kept = [c for c in cs if _fold_compare(c) is not True]
        if len(kept) == len(cs):
            return None
        node.filter = _and_all(kept)
        return node
    if not isinstance(node, FilterNode):
        return None
    cs = _conjuncts(node.condition)
    kept = [c for c in cs if _fold_compare(c) is not True]
    if len(kept) == len(cs):
        return None
    if not kept:
        return node.input
    return FilterNode(node.input, _and_all(kept))


def _filter_into_scan(node: Node) -> Node | None:
    """Filter(Scan) -> Scan with merged leaf filter when every conjunct
    resolves against the scan [PinotFilterIntoScanRule — lets the leaf run
    the fused v1 device kernel over the whole predicate]."""
    if isinstance(node, FilterNode) and isinstance(node.input, Scan):
        scan = node.input
        if _filter_resolves(node.condition, scan.fields):
            scan.filter = _and_all(
                ([scan.filter] if scan.filter else []) + [_strip_qualifiers(node.condition, scan)]
            )
            return scan
    return None


def _filter_push_residual(node: Node) -> Node | None:
    """Filter above anything: push each conjunct toward the deepest scan
    that can evaluate it, keep the rest [FilterJoinRule/transpose family via
    the planner's own _push_filter]."""
    if not isinstance(node, FilterNode) or isinstance(node.input, (Scan, FilterNode)):
        return None
    cs = _conjuncts(node.condition)
    residual = [c for c in cs if not _push_filter(node.input, c)]
    if len(residual) == len(cs):
        return None
    if not residual:
        return node.input
    return FilterNode(node.input, _and_all(residual))


def _map_filter_idents(f: ast.FilterExpr, mapping: dict[str, str]) -> ast.FilterExpr:
    """Rewrite every identifier in a filter through `mapping` (names absent
    from the mapping pass through unchanged)."""

    def fix_e(e: ast.Expr) -> ast.Expr:
        if isinstance(e, ast.Identifier):
            return ast.Identifier(mapping.get(e.name, e.name))
        if isinstance(e, ast.FunctionCall):
            inner = fix_f(e.filter) if e.filter is not None else None
            return ast.FunctionCall(e.name, tuple(fix_e(a) for a in e.args), e.distinct, inner)
        if isinstance(e, ast.BinaryOp):
            return ast.BinaryOp(e.op, fix_e(e.left), fix_e(e.right))
        if isinstance(e, ast.CaseWhen):
            return ast.CaseWhen(
                tuple((fix_f(c), fix_e(v)) for c, v in e.whens),
                fix_e(e.else_) if e.else_ is not None else None,
            )
        return e

    def fix_f(x):
        if isinstance(x, ast.And):
            return ast.And(tuple(fix_f(c) for c in x.children))
        if isinstance(x, ast.Or):
            return ast.Or(tuple(fix_f(c) for c in x.children))
        if isinstance(x, ast.Not):
            return ast.Not(fix_f(x.child))
        if isinstance(x, ast.Compare):
            return ast.Compare(x.op, fix_e(x.left), fix_e(x.right))
        if isinstance(x, ast.Between):
            return ast.Between(fix_e(x.expr), fix_e(x.low), fix_e(x.high), x.negated)
        if isinstance(x, ast.In):
            return ast.In(fix_e(x.expr), tuple(fix_e(v) for v in x.values), x.negated)
        if isinstance(x, ast.Like):
            return ast.Like(fix_e(x.expr), x.pattern, x.negated)
        if isinstance(x, ast.RegexpLike):
            return ast.RegexpLike(fix_e(x.expr), x.pattern)
        if isinstance(x, ast.IsNull):
            return ast.IsNull(fix_e(x.expr), x.negated)
        if isinstance(x, ast.BoolAssert):
            return ast.BoolAssert(fix_e(x.expr), x.want_true, x.negated)
        if isinstance(x, ast.DistinctFrom):
            return ast.DistinctFrom(fix_e(x.left), fix_e(x.right), x.negated)
        return x

    return fix_f(f)


def _filter_through_rename(node: Node) -> Node | None:
    """Filter(Rename(x)) -> Rename(Filter'(x)): identifiers re-qualified
    under the subquery alias map back to the inner field names, so later
    FilterIntoScan/FilterPushToScan passes can land the predicate on the
    leaf [FilterProjectTransposeRule over the alias boundary]."""
    if not isinstance(node, FilterNode) or not isinstance(node.input, L.Rename):
        return None
    rn = node.input
    ids: set[str] = set()
    L._idents_filter(node.condition, ids)
    mapping: dict[str, str] = {}
    for ident in ids:
        idx = L.try_resolve(rn.fields, ident)
        if idx is None:
            return None  # references something beyond the rename's surface
        mapping[ident] = rn.input.fields[idx].canon
    rn.input = FilterNode(rn.input, _map_filter_idents(node.condition, mapping))
    # Rename.fields were computed from the ORIGINAL input; the filter keeps
    # them identical, so no recompute is needed
    return rn


def _filter_through_project(node: Node) -> Node | None:
    """Filter(Project(x)) -> Project(Filter'(x)) when every referenced
    output column is a plain pass-through identifier
    [FilterProjectTransposeRule]. Computed columns block the transpose
    (evaluating them twice or re-ordering against non-determinism is the
    classic unsound case)."""
    if not isinstance(node, FilterNode) or not isinstance(node.input, Project):
        return None
    proj = node.input
    ids: set[str] = set()
    L._idents_filter(node.condition, ids)
    mapping: dict[str, str] = {}
    for ident in ids:
        idx = L.try_resolve(proj.fields, ident)
        if idx is None or not isinstance(proj.exprs[idx], ast.Identifier):
            return None
        mapping[ident] = proj.exprs[idx].name
    proj.input = FilterNode(proj.input, _map_filter_idents(node.condition, mapping))
    return proj


def _identity_project_prune(node: Node) -> Node | None:
    """Project that renames nothing and keeps every input column in order ->
    dropped [ProjectRemoveRule]."""
    if not isinstance(node, Project):
        return None
    fin = node.input.fields
    if node.n_visible != len(node.exprs) or len(node.exprs) != len(fin):
        return None
    for e, name, f in zip(node.exprs, node.names, fin):
        if not (isinstance(e, ast.Identifier) and e.name in (f.name, f.canon) and name == f.name):
            return None
    return node.input


LOGICAL_RULES = [
    Rule("FilterMerge", _filter_merge),
    Rule("ConstantFoldFilter", _constant_fold_filter),
    Rule("FilterThroughRename", _filter_through_rename),
    Rule("FilterThroughProject", _filter_through_project),
    Rule("FilterIntoScan", _filter_into_scan),
    Rule("FilterPushToScan", _filter_push_residual),
    Rule("IdentityProjectPrune", _identity_project_prune),
]


# ---------------------------------------------------------------------------
# physical rules (run over the exchange-annotated tree)
# ---------------------------------------------------------------------------


def _collapse_exchange(node: Node) -> Node | None:
    """Exchange(a)(Exchange(b)(x)) -> Exchange(a)(x) for row-preserving
    inner distributions (hash/random/singleton): the outer exchange
    re-partitions everything anyway, so the inner shuffle moves bytes
    nobody observes [ExchangeRemoveConstantKeysRule flavor]. An inner
    BROADCAST multiplies rows per worker and must NOT collapse. Today's
    insert_exchanges never stacks exchanges — this is a defensive invariant
    for composed/hand-built plans."""
    if (
        isinstance(node, Exchange)
        and isinstance(node.input, Exchange)
        and node.input.dist != L.BROADCAST
    ):
        node.input = node.input.input
        return node
    return None


def _limit_through_exchange(node: Node) -> Node | None:
    """Sort(keys, limit)(Exchange SINGLETON (x)) -> add a per-worker local
    top-(limit+offset) below the exchange [SortExchangeTranspose / the
    reference's sort-pushdown]: every worker ships at most limit+offset
    rows instead of its whole partition; the global Sort re-sorts the
    k*workers survivors. Sound because global top-k is a subset of the
    union of per-worker top-k under the same key order."""
    if (
        isinstance(node, Sort)
        and node.limit is not None
        and isinstance(node.input, Exchange)
        and node.input.dist == L.SINGLETON
        and not isinstance(node.input.input, (Sort, L.StageInput))
    ):
        ex = node.input
        local = Sort(ex.input, list(node.keys), node.limit + node.offset, 0)
        ex.input = local
        return node
    return None


#: the planning catalog for the optimize() call in flight — set by
#: build_stage_plan so stat-gated rules (AggregateJoinTranspose) can read
#: row counts / NDV without widening every Rule's signature. contextvars
#: keep concurrent per-query plans isolated.
PLAN_CATALOG: contextvars.ContextVar = contextvars.ContextVar("plan_catalog", default=None)

#: fire the transpose only when the pushed partial is estimated to collapse
#: the probe side by at least this factor (NDV product vs estimated rows) —
#: the Calcite AggregateJoinTransposeRule is cost-gated for the same reason:
#: partial-aggregating a near-unique key (e.g. an FK to a large dim) groups
#: everything and collapses nothing.
TRANSPOSE_MIN_COLLAPSE = 4.0

#: multiplicity-safe decomposable functions for the transpose below. A
#: non-unique build-side key duplicates each probe-side partial row m times;
#: the FINAL merge then re-sums, so sum/count/avg scale by exactly m — the
#: same m the un-transposed join would have applied row-by-row — and
#: min/max/distinct are duplicate-idempotent. percentile/tdigest partials
#: are value collections where duplication CHANGES the result: excluded.
_TRANSPOSE_AGGS = {
    "count",
    "sum",
    "min",
    "max",
    "avg",
    "minmaxrange",
    "distinctcount",
    "distinctcountbitmap",
    "distinctcounthll",
}


def _scan_tables(node: Node, out: list[tuple[str | None, str]]) -> None:
    """Collect (qualifier, table) for every Scan in a subtree."""
    if isinstance(node, Scan):
        out.append((node.qualifier, node.table))
    for _, child in _children(node):
        _scan_tables(child, out)


def _transpose_collapses(pushed: list[ast.Expr], left_sub: Node) -> bool:
    """Cardinality gate: the NDV product of the pushed group keys must be
    at least TRANSPOSE_MIN_COLLAPSE times smaller than the probe side's
    estimated rows. Unknown NDV (no catalog, expression keys, columns with
    no dictionary stats) fails closed — the un-transposed plan is the safe
    default for near-unique keys."""
    cat = PLAN_CATALOG.get()
    if cat is None or not getattr(cat, "ndv", None):
        return False
    scans: list[tuple[str | None, str]] = []
    _scan_tables(left_sub, scans)
    by_qual = {q: t for q, t in scans if q is not None}
    for _, t in scans:
        by_qual.setdefault(t, t)  # unaliased scans are referenced by table name
    sole_table = scans[0][1] if len(scans) == 1 else None
    ndv_product = 1.0
    for g in pushed:
        ids: set[str] = set()
        L._idents_expr(g, ids)
        for ident in ids:
            q, n = ident.split(".", 1) if "." in ident else (None, ident)
            # an unqualified ident is attributable only when one scan exists
            table = by_qual.get(q) if q is not None else sole_table
            card = cat.ndv.get(table, {}).get(n) if table else None
            if card is None:
                return False
            ndv_product *= max(1, card)
    est = L.estimate_rows(left_sub, cat.row_counts)
    return ndv_product * TRANSPOSE_MIN_COLLAPSE <= est


def _agg_join_transpose(node: Node) -> Node | None:
    """AggregatePartial(Join(L, R)) -> Project(Join(AggregatePartial'(L), R))
    [AggregateJoinTransposeRule]: when every aggregation argument lives on
    the probe side of an INNER equi-join, the partial aggregate pushes below
    the join keyed by (join keys + probe-side group keys). The fact side
    then collapses to one row per key combination BEFORE the join — and the
    pushed partial lands on the leaf stage, where the fused v1 device
    group-by executes it on-chip. The final Aggregate re-merges above, which
    is what makes non-unique build-side keys safe (see _TRANSPOSE_AGGS).

    The Project restores the positional [group keys..., part cols...] layout
    the final-mode Aggregate expects from its original partial."""
    from pinot_tpu_torch.query.context import canonical

    if not isinstance(node, L.Aggregate) or node.mode != "partial":
        return None
    j = node.input
    if (
        not isinstance(j, L.Join)
        or j.kind != "inner"
        or j.post_filter is not None
        or not j.left_keys
    ):
        return None
    lex = j.left if isinstance(j.left, Exchange) else None
    left_sub = lex.input if lex else j.left
    lf, rf = left_sub.fields, j.right.fields

    def _on(fields, ids: set[str]) -> bool:
        return bool(ids) and all(L.try_resolve(fields, i) is not None for i in ids)

    for a in node.aggs:
        if a.func not in _TRANSPOSE_AGGS or a.arg2 is not None:
            return None
        ids: set[str] = set()
        if a.arg is not None:
            L._idents_expr(a.arg, ids)
        if a.filter is not None:
            L._idents_filter(a.filter, ids)
        if ids and not _on(lf, ids):
            return None
    l_groups = []
    for g in node.group_exprs:
        ids = set()
        L._idents_expr(g, ids)
        if _on(lf, ids):
            l_groups.append(g)
        elif not _on(rf, ids):
            return None  # right-side keys ride the join; mixed/literal: bail
    for k in j.left_keys:
        ids = set()
        L._idents_expr(k, ids)
        if not _on(lf, ids):
            return None
    seen: set[str] = set()
    pushed = []
    for g in list(j.left_keys) + l_groups:
        c = canonical(g)
        if c not in seen:
            seen.add(c)
            pushed.append(g)
    if not _transpose_collapses(pushed, left_sub):
        return None
    partial2 = L.Aggregate(left_sub, pushed, list(node.aggs), mode="partial")
    new_left = Exchange(partial2, lex.dist, list(lex.key_exprs)) if lex else partial2
    new_join = L.Join(new_left, j.right, j.kind, list(j.left_keys), list(j.right_keys))
    exprs, names = [], []
    for f in node.fields:
        if L.try_resolve(new_join.fields, f.canon) is None:
            return None  # a layout column vanished — leave the plan alone
        exprs.append(ast.Identifier(f.canon))
        names.append(f.canon)
    proj = Project(new_join, exprs, names)
    proj.fields = list(node.fields)  # exact original layout incl. qualifiers
    return proj


PHYSICAL_RULES = [
    Rule("CollapseExchange", _collapse_exchange),
    Rule("AggregateJoinTranspose", _agg_join_transpose),
    Rule("LimitThroughExchange", _limit_through_exchange),
]
