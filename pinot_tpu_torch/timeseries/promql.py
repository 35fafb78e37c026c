"""PromQL-flavored language plugin — the SECOND timeseries language, proving
the TimeSeriesLogicalPlanner SPI is language-neutral (the reference ships
m3ql as a plugin and the SPI exists so engines like PromQL can plug in;
PinotTimeSeriesConfiguration's language registration).

Grammar subset (instant-vector pipeline over the range request):

    expr     := agg_expr | fn_expr | selector
    agg_expr := ("sum"|"min"|"max"|"avg") ["by" "(" tag{,tag} ")"] "(" expr ")"
    fn_expr  := fname "(" expr ["," number] ")"
    selector := metric "{" label "=" '"' value '"' {"," ...} "}" | metric

A metric name is `<table>:<value_column>` (e.g. `events:value`) or
`<table>:<value>:<agg>` to override the leaf aggregation (default sum;
`<table>::count` is COUNT(*)). Label matchers lower to the leaf's SQL
filter; `by (...)` tags lower to the leaf group-by + a groupBy transform;
functions map onto the shared pipeline-op registry (rate, abs->absolute,
clamp_min->clampmin, ...). The output plan tree is the same
LeafTimeSeriesPlanNode/TransformNode shape m3ql produces — one physical
engine serves both languages.

This is the JAX package's `timeseries/promql.py`, unchanged.
"""

from __future__ import annotations

import re

from pinot_tpu_torch.timeseries.language import register_timeseries_language

_AGGS = {"sum", "min", "max", "avg"}
#: promql function name -> pipeline op name (+ whether args pass through)
_FNS = {
    "rate": "rate",
    "abs": "absolute",
    "delta": "rate",  # bucketed delta ~ rate without the step divide; see below
    "clamp_min": "clampmin",
    "clamp_max": "clampmax",
    "scalar_mul": "scale",
    "moving_avg": "movingavg",
    "integral": "integral",
    "per_second": "persecond",
    "transform_null": "transformnull",
    "topk": "topk",
    "bottomk": "bottomk",
    "keep_last_value": "keeplastvalue",
}

_TOKEN = re.compile(
    r"\s*(?:(?P<num>-?\d+(?:\.\d+)?)|(?P<name>[A-Za-z_][\w.]*)|(?P<str>\"[^\"]*\")|(?P<sym>[(){}=,:]))"
)


def _tokens(q: str) -> list[str]:
    out, i = [], 0
    while i < len(q):
        m = _TOKEN.match(q, i)
        if m is None:
            if q[i:].strip():
                raise ValueError(f"promql: cannot tokenize at {q[i:]!r}")
            break
        out.append(next(g for g in (m.group("num"), m.group("name"), m.group("str"), m.group("sym")) if g))
        i = m.end()
    return out


class _Parser:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, want: str | None = None) -> str:
        if self.i >= len(self.toks):
            raise ValueError("promql: unexpected end of query")
        t = self.toks[self.i]
        if want is not None and t != want:
            raise ValueError(f"promql: expected {want!r}, got {t!r}")
        self.i += 1
        return t

    def expr(self):
        from pinot_tpu_torch.timeseries.plan import TransformNode

        t = self.peek()
        if t in _AGGS:
            agg = self.take()
            by_tags: list[str] = []
            if self.peek() == "by":
                self.take("by")
                self.take("(")
                while True:
                    by_tags.append(self.take())
                    if self.peek() == ",":
                        self.take(",")
                        continue
                    break
                self.take(")")
            self.take("(")
            inner, leaf = self.expr()
            self.take(")")
            if not by_tags:
                return TransformNode(agg, [], inner), leaf
            # `by (tags)`: tags flow to the leaf's SQL GROUP BY; the regroup
            # transform re-aggregates by summing, which is only sound for
            # sum (min-of-per-series-mins etc. would need a different
            # regroup) — mirror that restriction explicitly
            if agg != "sum":
                raise ValueError(f"promql: only sum supports 'by' grouping (got {agg})")
            leaf.group_by = sorted(set(leaf.group_by) | set(by_tags))
            return TransformNode("groupby", by_tags, inner), leaf
        if t in _FNS:
            fn = self.take()
            self.take("(")
            inner, leaf = self.expr()
            args: list[str] = []
            while self.peek() == ",":
                self.take(",")
                args.append(self.take())
            self.take(")")
            node = TransformNode(_FNS[fn], args, inner)
            if fn == "delta":
                # delta = rate * step: rate then scale back up
                node = TransformNode("scale", ["__step__"], node)
            return node, leaf
        return self.selector()

    def selector(self):
        from pinot_tpu_torch.timeseries.plan import LeafTimeSeriesPlanNode

        # metric = table[:value[:agg]]; ':' tokenizes separately, and the
        # value slot may be empty (events::count)
        parts = [self.take()]
        while self.peek() == ":":
            self.take(":")
            nxt = self.peek()
            parts.append(self.take() if nxt is not None and nxt not in "(){}=,:" else "")
        table = parts[0]
        value = parts[1] if len(parts) > 1 and parts[1] else "*"
        agg = parts[2] if len(parts) > 2 else ("count" if value == "*" else "sum")
        filters: list[str] = []
        time_column = "ts"
        if self.peek() == "{":
            self.take("{")
            while self.peek() != "}":
                label = self.take()
                self.take("=")
                val = self.take()
                if not (val.startswith('"') and val.endswith('"')):
                    raise ValueError("promql: label value must be double-quoted")
                if label == "__time__":
                    # reserved matcher selects the time column (PromQL has no
                    # fetch-style time= knob; this keeps non-'ts' tables
                    # queryable through this language)
                    time_column = val[1:-1]
                else:
                    filters.append(f"{label} = '{val[1:-1]}'")
                if self.peek() == ",":
                    self.take(",")
            self.take("}")
        leaf = LeafTimeSeriesPlanNode(
            table=table,
            value_expr=value,
            time_column=time_column,
            filter_sql=" AND ".join(filters),
            agg=agg,
        )
        return leaf, leaf


def plan_promql(query: str):
    """Parse a PromQL-subset query into the shared plan tree."""
    p = _Parser(_tokens(query))
    root, _leaf = p.expr()
    if p.peek() is not None:
        raise ValueError(f"promql: trailing tokens at {p.toks[p.i:]}")
    return root


register_timeseries_language("promql", plan_promql)
