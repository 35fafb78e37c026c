"""Filter optimizer: rule rewrites applied to a query's WHERE tree before
planning.

Reference parity: QueryOptimizer's filter rules (pinot-core/.../query/
optimizer/filter/): FlattenAndOrFilterOptimizer (collapse nested AND/AND,
OR/OR), MergeRangeFilterOptimizer (conjunctive ranges on one column fuse
into a single interval; empty intervals become a match-nothing predicate),
MergeEqInFilterOptimizer (disjunctive EQ/IN on one column fuse into one IN).
NumericalFilterOptimizer's int-vs-fractional-literal rewrites already live
in plan lowering (_int_compare).

Applied by QueryEngine.make_context (the v1 path, device plan + host
fallback; the v2 planner does its own conjunct splitting and pushdown).
Range merging is restricted to single-value columns: under MV any-match
semantics `mv > 5 AND mv < 3` can be satisfied by DIFFERENT values of one
doc, so interval intersection would be unsound (the reference's
MergeRangeFilterOptimizer merges SV columns only for the same reason).
"""

from __future__ import annotations

from pinot_tpu_torch.query.ast import (
    And,
    Between,
    Compare,
    CompareOp,
    FilterExpr,
    Identifier,
    In,
    Literal,
    Not,
    Or,
)


def optimize_filter(f: FilterExpr | None, mv_cols: "set[str]" = frozenset()) -> FilterExpr | None:
    """`mv_cols`: columns whose range predicates must NOT merge (MV
    any-match). EQ/IN merging stays safe for MV (any-match distributes
    over OR)."""
    if f is None:
        return None
    f = _flatten(f)
    f = _merge_ranges(f, mv_cols)
    f = _merge_eq_in(f)
    return f


# -- flatten ------------------------------------------------------------------


def _flatten(f: FilterExpr) -> FilterExpr:
    if isinstance(f, And):
        out = []
        for c in (_flatten(c) for c in f.children):
            out.extend(c.children if isinstance(c, And) else [c])
        return out[0] if len(out) == 1 else And(tuple(out))
    if isinstance(f, Or):
        out = []
        for c in (_flatten(c) for c in f.children):
            out.extend(c.children if isinstance(c, Or) else [c])
        return out[0] if len(out) == 1 else Or(tuple(out))
    if isinstance(f, Not):
        return Not(_flatten(f.child))
    return f


# -- merge conjunctive ranges -------------------------------------------------

_INF = float("inf")


def _num_lit(e) -> "float | None":
    """Numeric literal as float, or None when absent OR when a float
    round-trip would corrupt an int bound (|v| > 2^53): such predicates are
    left unmerged rather than rewritten with a rounded literal."""
    if isinstance(e, Literal) and isinstance(e.value, (int, float)) and not isinstance(e.value, bool):
        if isinstance(e.value, int) and abs(e.value) > 2**53:
            return None
        return float(e.value)
    return None


def _as_interval(f: FilterExpr) -> "tuple[str, float, bool, float, bool] | None":
    """Range predicate on a bare column with numeric literals ->
    (col, lo, lo_inclusive, hi, hi_inclusive)."""
    if isinstance(f, Compare) and isinstance(f.left, Identifier):
        v = _num_lit(f.right)
        if v is None:
            return None
        c = f.left.name
        return {
            CompareOp.LT: (c, -_INF, False, v, False),
            CompareOp.LTE: (c, -_INF, False, v, True),
            CompareOp.GT: (c, v, False, _INF, False),
            CompareOp.GTE: (c, v, True, _INF, False),
        }.get(f.op)
    if isinstance(f, Between) and not f.negated and isinstance(f.expr, Identifier):
        lo, hi = _num_lit(f.low), _num_lit(f.high)
        if lo is None or hi is None:
            return None
        return (f.expr.name, lo, True, hi, True)
    return None


def _interval_to_filter(col: str, lo, lo_inc, hi, hi_inc) -> FilterExpr:
    ident = Identifier(col)
    if lo == -_INF:
        return Compare(CompareOp.LTE if hi_inc else CompareOp.LT, ident, Literal(_unfloat(hi)))
    if hi == _INF:
        return Compare(CompareOp.GTE if lo_inc else CompareOp.GT, ident, Literal(_unfloat(lo)))
    if lo_inc and hi_inc:
        return Between(ident, Literal(_unfloat(lo)), Literal(_unfloat(hi)))
    parts = [
        Compare(CompareOp.GTE if lo_inc else CompareOp.GT, ident, Literal(_unfloat(lo))),
        Compare(CompareOp.LTE if hi_inc else CompareOp.LT, ident, Literal(_unfloat(hi))),
    ]
    return And(tuple(parts))


def _unfloat(v: float):
    return int(v) if v == int(v) and abs(v) < 2**53 else v


#: canonical match-nothing predicate (empty merged interval)
MATCH_NOTHING = Compare(CompareOp.EQ, Literal(1), Literal(0))


def _merge_ranges(f: FilterExpr, mv_cols: "set[str]" = frozenset()) -> FilterExpr:
    if isinstance(f, Or):
        return Or(tuple(_merge_ranges(c, mv_cols) for c in f.children))
    if isinstance(f, Not):
        return Not(_merge_ranges(f.child, mv_cols))
    if not isinstance(f, And):
        return f
    by_col: dict[str, list] = {}
    rest: list[FilterExpr] = []
    for c in f.children:
        c = _merge_ranges(c, mv_cols)
        iv = _as_interval(c)
        if iv is None or iv[0] in mv_cols:
            rest.append(c)
        else:
            by_col.setdefault(iv[0], []).append((iv[1:], c))
    merged: list[FilterExpr] = []
    for col, entries in by_col.items():
        if len(entries) == 1:
            # single range: keep the ORIGINAL predicate (no literal rebuild)
            merged.append(entries[0][1])
            continue
        ivs = [iv for iv, _c in entries]
        lo, lo_inc = max((l, linc) for (l, linc, _h, _hc) in ivs)  # noqa: E741
        # tightest bound: larger lo wins; on equal lo, EXCLUSIVE is tighter
        lo_inc = all(linc for (l, linc, _h, _hc) in ivs if l == lo)
        hi, hi_inc = min((h, hc) for (_l, _li, h, hc) in ivs)
        hi_inc = all(hc for (_l, _li, h, hc) in ivs if h == hi)
        if lo > hi or (lo == hi and not (lo_inc and hi_inc)):
            return MATCH_NOTHING  # contradictory conjunction
        merged.append(_interval_to_filter(col, lo, lo_inc, hi, hi_inc))
    out = rest + merged
    return out[0] if len(out) == 1 else And(tuple(out))


# -- merge disjunctive EQ/IN --------------------------------------------------


def _merge_eq_in(f: FilterExpr) -> FilterExpr:
    if isinstance(f, And):
        return And(tuple(_merge_eq_in(c) for c in f.children))
    if isinstance(f, Not):
        return Not(_merge_eq_in(f.child))
    if not isinstance(f, Or):
        return f
    by_col: dict[str, list] = {}
    rest: list[FilterExpr] = []
    for c in f.children:
        c = _merge_eq_in(c)
        if (
            isinstance(c, Compare)
            and c.op == CompareOp.EQ
            and isinstance(c.left, Identifier)
            and isinstance(c.right, Literal)
        ):
            by_col.setdefault(c.left.name, []).append(c.right)
        elif isinstance(c, In) and not c.negated and isinstance(c.expr, Identifier) and all(
            isinstance(v, Literal) for v in c.values
        ):
            by_col.setdefault(c.expr.name, []).extend(c.values)
        else:
            rest.append(c)
    merged: list[FilterExpr] = []
    for col, lits in by_col.items():
        if len(lits) == 1:
            merged.append(Compare(CompareOp.EQ, Identifier(col), lits[0]))
        else:
            seen: dict = {}
            for lit in lits:  # dedup, stable order
                seen.setdefault(lit.value, lit)
            merged.append(In(Identifier(col), tuple(seen.values())))
    out = rest + merged
    return out[0] if len(out) == 1 else Or(tuple(out))
