"""The plain reference: SQL aggregations answered with numpy from the
generated arrays.

It answers the single-table aggregation queries of the traffic mixes:
SELECT of group columns and SUM / COUNT / AVG / MIN / MAX over arithmetic
(+ - *) of columns and literals, WHERE of comparisons, BETWEEN, IN, AND, OR,
NOT and parentheses, GROUP BY columns, ORDER BY select columns or aliases
(ASC / DESC), LIMIT. It has a parser of its own and reads the generated
table (`olap_bench.table.Table` on the host): a dictionary column through
the table-wide sorted dictionary the generator made, never the program's.

Arithmetic is exact. A decimal column holds integers of 10**-scale, and an
expression carries its scale: + and - align scales, * adds them. Sums are
exact integers (`_exact_sum`), and a result becomes a float once, at the end,
by Python's correctly rounded integer division; AVG is the exact sum over the
count. So the reference gives each answer correctly rounded, and a gap to it
is the program's whole error.

`answer_all` answers many queries at once. Queries that differ only in the
bounds of range predicates on one dictionary column (TPC-H Q1's ship date
under each DELTA) share one pass grouped by that column too; each query then
adds up the partials of the ids its bounds take.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction

import numpy as np

# -- parsing -----------------------------------------------------------------

_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+(?:\.\d+)?)|(?P<str>'(?:[^']|'')*')|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<op><=|>=|<>|!=|[-+*/(),=<>]))"
)
_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "ORDER", "LIMIT", "AS", "AND", "OR", "NOT",
    "BETWEEN", "IN", "ASC", "DESC",
}  # fmt: skip
AGGREGATES = {"SUM", "COUNT", "AVG", "MIN", "MAX"}


@dataclass(frozen=True)
class Node:
    kind: str  # col, num, str, neg, bin, cmp, between, in, and, or, not, agg
    op: str = ""
    args: tuple = ()
    value: object = None


@dataclass
class Query:
    select: list  # [(Node, name)]
    table: str
    where: Node | None
    group_by: list  # [Node]
    order_by: list  # [(Node, descending)]
    limit: int | None


def _tokens(sql: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    sql = sql.strip()
    while pos < len(sql):
        m = _TOKEN.match(sql, pos)
        if m is None or m.end() == pos:
            raise ValueError(f"cannot read SQL at {sql[pos:pos + 20]!r}")
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "name" and text.upper() in _KEYWORDS | AGGREGATES:
            kind, text = "kw", text.upper()
        out.append((kind, text))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokens(sql)
        self.i = 0

    def peek(self, *texts) -> bool:
        return self.i < len(self.toks) and self.toks[self.i][1] in texts

    def take(self, text: str | None = None) -> tuple[str, str]:
        if self.i >= len(self.toks):
            raise ValueError("unexpected end of SQL")
        tok = self.toks[self.i]
        if text is not None and tok[1] != text:
            raise ValueError(f"expected {text!r}, got {tok[1]!r}")
        self.i += 1
        return tok

    def query(self) -> Query:
        self.take("SELECT")
        select = [self.select_item()]
        while self.peek(","):
            self.take()
            select.append(self.select_item())
        self.take("FROM")
        table = self.take()[1]
        where = group_by = order_by = limit = None
        if self.peek("WHERE"):
            self.take()
            where = self.expr()
        if self.peek("GROUP"):
            self.take(), self.take("BY")
            group_by = [self.expr()]
            while self.peek(","):
                self.take()
                group_by.append(self.expr())
        if self.peek("ORDER"):
            self.take(), self.take("BY")
            order_by = [self.order_item()]
            while self.peek(","):
                self.take()
                order_by.append(self.order_item())
        if self.peek("LIMIT"):
            self.take()
            limit = int(self.take()[1])
        if self.i != len(self.toks):
            raise ValueError(f"unread SQL from {self.toks[self.i][1]!r}")
        return Query(select, table, where, group_by or [], order_by or [], limit)

    def select_item(self) -> tuple[Node, str | None]:
        node = self.expr()
        name = None
        if self.peek("AS"):
            self.take()
            name = self.take()[1]
        return node, name

    def order_item(self) -> tuple[Node, bool]:
        node = self.expr()
        desc = False
        if self.peek("ASC", "DESC"):
            desc = self.take()[1] == "DESC"
        return node, desc

    def expr(self) -> Node:
        node = self.conj()
        while self.peek("OR"):
            self.take()
            node = Node("or", args=(node, self.conj()))
        return node

    def conj(self) -> Node:
        node = self.neg()
        while self.peek("AND"):
            self.take()
            node = Node("and", args=(node, self.neg()))
        return node

    def neg(self) -> Node:
        if self.peek("NOT"):
            self.take()
            return Node("not", args=(self.neg(),))
        return self.predicate()

    def predicate(self) -> Node:
        left = self.additive()
        if self.peek("=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.take()[1]
            return Node("cmp", "<>" if op == "!=" else op, (left, self.additive()))
        negate = False
        if self.peek("NOT"):
            self.take()
            negate = True
        if self.peek("BETWEEN"):
            self.take()
            lo = self.additive()
            self.take("AND")
            node = Node("between", args=(left, lo, self.additive()))
        elif self.peek("IN"):
            self.take(), self.take("(")
            items = [self.additive()]
            while self.peek(","):
                self.take()
                items.append(self.additive())
            self.take(")")
            node = Node("in", args=(left, *items))
        elif negate:
            raise ValueError("NOT must precede BETWEEN or IN here")
        else:
            return left
        return Node("not", args=(node,)) if negate else node

    def additive(self) -> Node:
        node = self.term()
        while self.peek("+", "-"):
            op = self.take()[1]
            node = Node("bin", op, (node, self.term()))
        return node

    def term(self) -> Node:
        node = self.unary()
        while self.peek("*", "/"):
            op = self.take()[1]
            node = Node("bin", op, (node, self.unary()))
        return node

    def unary(self) -> Node:
        if self.peek("-"):
            self.take()
            return Node("neg", args=(self.unary(),))
        return self.primary()

    def primary(self) -> Node:
        kind, text = self.take()
        if text == "(":
            node = self.expr()
            self.take(")")
            return node
        if kind == "num":
            return Node("num", value=text)
        if kind == "str":
            return Node("str", value=text[1:-1].replace("''", "'"))
        if kind == "kw" and text in AGGREGATES:
            self.take("(")
            if self.peek("*"):
                self.take()
                arg = None
            else:
                arg = self.expr()
            self.take(")")
            return Node("agg", text, (arg,) if arg is not None else ())
        if kind == "name":
            return Node("col", value=text)
        raise ValueError(f"unexpected {text!r}")


def parse(sql: str) -> Query:
    return _Parser(sql).query()


# -- evaluation --------------------------------------------------------------


@dataclass
class _Num:
    """Exact numbers: integers (an array, or a Python int for a literal) of
    10**-scale."""

    v: object
    scale: int


def _align(a: _Num, b: _Num) -> tuple[object, object, int]:
    s = max(a.scale, b.scale)
    return a.v * 10 ** (s - a.scale), b.v * 10 ** (s - b.scale), s


def _literal_num(text: str) -> _Num:
    whole, _, frac = text.partition(".")
    return _Num(int(whole + frac), len(frac))


def _exact_sum(keys: np.ndarray, values: np.ndarray, n: int, most: int) -> list[int]:
    """Exact integer sum of `values` (int64) for each key 0..n-1, where no
    key has more than `most` rows: one bincount in float64 where no sum can
    reach 2**53, else the values split into a 26-bit low part and the rest,
    each part summed so."""
    values = np.asarray(values, dtype=np.int64)
    top = int(np.abs(values).max()) if len(values) else 0
    if top * most < 1 << 53:
        return [int(v) for v in np.bincount(keys, weights=values.astype(np.float64), minlength=n).tolist()]
    if top >= 1 << 52 or most >= 1 << 26:
        raise OverflowError("values too large, or too many, for the exact sum")
    lo = np.bincount(keys, weights=(values & ((1 << 26) - 1)).astype(np.float64), minlength=n)
    hi = np.bincount(keys, weights=(values >> 26).astype(np.float64), minlength=n)
    return [int(h) * (1 << 26) + int(lo_) for h, lo_ in zip(hi.tolist(), lo.tolist())]


def _compare_raw(data: np.ndarray, op: str, bound: Fraction) -> np.ndarray:
    """`data op bound` for integer data and an exact bound, compared in the
    data's own dtype."""
    floor, ceil = bound.numerator // bound.denominator, -(-bound.numerator // bound.denominator)
    if op == "=":
        return data == floor if floor == ceil else np.zeros(len(data), dtype=bool)
    return {"<": lambda: data < ceil, "<=": lambda: data <= floor, ">": lambda: data > floor, ">=": lambda: data >= ceil}[op]()


class Evaluator:
    """Queries over one generated table (on the host)."""

    def __init__(self, table):
        self.table = table
        self.n = table.n_rows

    # row values -------------------------------------------------------------

    def value(self, node: Node, rows: np.ndarray | None = None) -> _Num:
        """A numeric expression over the rows (`rows`: indices, or all)."""
        if node.kind == "num":
            return _literal_num(node.value)
        if node.kind == "col":
            col = self.table.columns[node.value]
            data = col.data if rows is None else col.data[rows]
            if col.dictionary is not None:
                if col.dictionary.dtype.kind not in "iu":
                    raise ValueError(f"{node.value} is not numeric")
                return _Num(col.dictionary.astype(np.int64)[data], 0)
            if col.type == "DOUBLE" and col.scale is None:
                raise ValueError(f"{node.value}: a DOUBLE needs its decimal scale for exact arithmetic")
            return _Num(data.astype(np.int64), col.scale or 0)
        if node.kind == "neg":
            a = self.value(node.args[0], rows)
            return _Num(-a.v, a.scale)
        if node.kind == "bin":
            a, b = self.value(node.args[0], rows), self.value(node.args[1], rows)
            if node.op == "*":
                return _Num(a.v * b.v, a.scale + b.scale)
            x, y, s = _align(a, b)
            if node.op == "+":
                return _Num(x + y, s)
            if node.op == "-":
                return _Num(x - y, s)
        raise ValueError(f"unsupported expression {node}")

    def _id_range(self, col, op: str, lit: Node) -> tuple[int, int]:
        """[lo, hi) of the dictionary ids that satisfy `col op lit`."""
        values = col.dictionary
        if lit.kind == "str":
            key = lit.value
        elif values.dtype.kind in "iu":
            f = Fraction(lit.value)
            key = int(f) if f.denominator == 1 else float(f)
        else:
            raise ValueError(f"a {lit.kind} against a string dictionary")
        left = int(np.searchsorted(values, key, "left"))
        right = int(np.searchsorted(values, key, "right"))
        return {
            "=": (left, right),
            "<": (0, left),
            "<=": (0, right),
            ">": (right, len(values)),
            ">=": (left, len(values)),
        }[op]

    def mask(self, node: Node) -> np.ndarray:
        if node.kind == "and":
            return self.mask(node.args[0]) & self.mask(node.args[1])
        if node.kind == "or":
            return self.mask(node.args[0]) | self.mask(node.args[1])
        if node.kind == "not":
            return ~self.mask(node.args[0])
        if node.kind == "between":
            col, lo, hi = node.args
            return self.mask(Node("cmp", ">=", (col, lo))) & self.mask(Node("cmp", "<=", (col, hi)))
        if node.kind == "in":
            out = np.zeros(self.n, dtype=bool)
            for item in node.args[1:]:
                out |= self.mask(Node("cmp", "=", (node.args[0], item)))
            return out
        if node.kind == "cmp":
            left, right = node.args
            if left.kind in ("num", "str") and right.kind == "col":
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}
                return self.mask(Node("cmp", flip[node.op], (right, left)))
            if node.op == "<>":
                return ~self.mask(Node("cmp", "=", node.args))
            if left.kind == "col" and right.kind in ("num", "str"):
                col = self.table.columns[left.value]
                if col.dictionary is not None:
                    lo, hi = self._id_range(col, node.op, right)
                    return (col.data >= lo) & (col.data < hi)
                if right.kind == "num":
                    return _compare_raw(col.data, node.op, Fraction(right.value) * 10 ** (col.scale or 0))
            a, b = self.value(left), self.value(right)
            x, y, _ = _align(a, b)
            return {"=": np.equal, "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}[
                node.op
            ](x, y)
        raise ValueError(f"unsupported predicate {node}")

    # answers ----------------------------------------------------------------

    def _group_keys(self, group_by: list[Node], rows, n_rows: int):
        """(group index of each of the `n_rows` rows `rows` selects, number
        of groups, each group's key values)."""
        if not group_by:
            return np.zeros(n_rows, dtype=np.int64), 1, [()]
        codes, cards, decoders = [], [], []
        for g in group_by:
            if g.kind != "col":
                raise ValueError("GROUP BY takes columns")
            col = self.table.columns[g.value]
            data = col.data[rows]
            if col.dictionary is not None:
                codes.append(data.astype(np.int64))
                cards.append(len(col.dictionary))
                decoders.append(col.dictionary)
            else:
                uniq, inv = np.unique(data, return_inverse=True)
                codes.append(inv.astype(np.int64))
                cards.append(len(uniq))
                if col.scale is not None:
                    uniq = np.array([Fraction(int(u), 10**col.scale) for u in uniq], dtype=object)
                decoders.append(uniq)
        combined = np.zeros(n_rows, dtype=np.int64)
        for c, card in zip(codes, cards):
            combined = combined * card + c
        space = int(np.prod(cards, dtype=np.float64))
        if space <= 1 << 26:
            # a dense key space: the groups present by a count, no sort
            present = np.bincount(combined, minlength=space) > 0
            uniq = np.flatnonzero(present)
            inv = (np.cumsum(present) - 1)[combined]
        else:
            uniq, inv = np.unique(combined, return_inverse=True)
        keys = []
        for u in uniq.tolist():
            parts = []
            for card, dec in zip(reversed(cards), reversed(decoders)):
                u, r = divmod(u, card)
                parts.append(dec[r])
            keys.append(tuple(_py(p) for p in reversed(parts)))
        return inv.astype(np.int64), len(uniq), keys

    def partials(self, q: Query, where: Node | None, extra_group: list[Node]):
        """Per group (the query's GROUP BY, then `extra_group`): its key and
        each aggregation's exact partial (sum, count, min, max as needed)."""
        rows = np.flatnonzero(self.mask(where)) if where is not None else slice(None)
        n_rows = self.n if isinstance(rows, slice) else len(rows)
        inv, n_groups, keys = self._group_keys(q.group_by + extra_group, rows, n_rows)
        counts = np.bincount(inv, minlength=n_groups).tolist()
        aggs = []
        for node in _aggregations(q):
            arg = node.args[0] if node.args else None
            if arg is None:
                aggs.append({"count": counts, "scale": 0})
                continue
            val = self.value(arg, rows)
            v = np.broadcast_to(np.asarray(val.v, dtype=np.int64), (n_rows,))
            entry = {"count": counts, "scale": val.scale}
            if node.op in ("SUM", "AVG"):
                entry["sum"] = _exact_sum(inv, v, n_groups, max(counts, default=0))
            if node.op in ("MIN", "MAX"):
                order = np.lexsort((v, inv))
                first = np.searchsorted(inv[order], np.arange(n_groups), "left")
                last = np.searchsorted(inv[order], np.arange(n_groups), "right") - 1
                entry["min"] = [int(x) for x in v[order][first]]
                entry["max"] = [int(x) for x in v[order][last]]
            aggs.append(entry)
        return keys, aggs

    def answer(self, sql: str) -> list[list]:
        return self.answer_all([sql])[sql]

    def answer_all(self, sqls) -> dict[str, list[list]]:
        """The rows of every query in `sqls`."""
        out: dict[str, list[list]] = {}
        shared: dict[tuple, list] = {}
        for sql in dict.fromkeys(sqls):
            q = parse(sql)
            if q.table != self.table.name:
                raise ValueError(f"query of table {q.table!r}, the reference holds {self.table.name!r}")
            key, ranges = _range_split(q, self.table)
            shared.setdefault(key, []).append((sql, q, ranges))
        for key, members in shared.items():
            if key is None or len(members) == 1:
                for sql, q, _ in members:
                    out[sql] = _finish(q, *self.partials(q, q.where, []))
                continue
            col_name, rest, _shape = key
            col = self.table.columns[col_name]
            keys, aggs = self.partials(members[0][1], rest, [Node("col", value=col_name)])
            ids = np.searchsorted(col.dictionary, np.array([k[-1] for k in keys], dtype=col.dictionary.dtype))
            fold = _combine(keys, aggs, ids, len(col.dictionary))
            for sql, q, ranges in members:
                lo, hi = 0, len(col.dictionary)
                for op, lit in ranges:
                    a, b = self._id_range(col, op, lit)
                    lo, hi = max(lo, a), min(hi, b)
                out[sql] = _finish(q, *fold(lo, max(lo, hi)))
        return out


def _py(v):
    return v.item() if isinstance(v, np.generic) else v


def _aggregations(q: Query) -> list[Node]:
    out: list[Node] = []
    for node, _ in q.select:
        if node.kind != "agg":
            if node.kind != "col" or all(node != g for g in q.group_by):
                raise ValueError("a select item is an aggregation or a GROUP BY column")
            continue
        out.append(node)
    return out


def _combine(keys: list[tuple], aggs: list[dict], ids: np.ndarray, n_ids: int):
    """A function of an id range [lo, hi) of the shared column that folds
    the partials (`keys` ending in that column's value, whose id is in
    `ids`) into the groups of the keys less it: counts and sums by running
    totals over the ids, MIN and MAX over the partials in the range."""
    prefixes: dict[tuple, list[int]] = {}
    for i, k in enumerate(keys):
        prefixes.setdefault(k[:-1], []).append(i)

    def running(values: list, members: list[int]) -> list:
        acc = [0] * (n_ids + 1)
        for i in members:
            acc[int(ids[i]) + 1] += values[i]
        for j in range(n_ids):
            acc[j + 1] += acc[j]
        return acc

    totals = {
        p: [{name: running(a[name], members) for name in ("count", "sum") if name in a} for a in aggs]
        for p, members in prefixes.items()
    }

    def fold(lo: int, hi: int):
        new_keys, out = [], [{"scale": a["scale"], "count": []} for a in aggs]
        for p, members in prefixes.items():
            if totals[p][0]["count"][hi] == totals[p][0]["count"][lo]:
                continue
            new_keys.append(p)
            for a, t, e in zip(aggs, totals[p], out):
                for name, acc in t.items():
                    e.setdefault(name, []).append(acc[hi] - acc[lo])
                for name, pick in (("min", min), ("max", max)):
                    if name in a:
                        got = [a[name][i] for i in members if lo <= ids[i] < hi and a["count"][i]]
                        e.setdefault(name, []).append(pick(got) if got else None)
        return new_keys, out

    return fold


def _finish(q: Query, keys: list[tuple], aggs: list[dict]) -> list[list]:
    """The result rows: exact values to floats, ORDER BY, LIMIT."""
    agg_nodes = _aggregations(q)
    rows = []
    for g, key in enumerate(keys):
        if q.group_by and aggs and all(a["count"][g] == 0 for a in aggs):
            continue
        exact, ai = [], 0
        for node, _ in q.select:
            if node.kind == "agg":
                a = aggs[ai]
                ai += 1
                exact.append(_agg_value(node.op, a, g))
            else:
                exact.append(key[next(i for i, gb in enumerate(q.group_by) if gb == node)])
        rows.append(exact)
    if not q.group_by and not rows:
        rows = [[_agg_value(n.op, {"count": [0], "scale": 0}, 0) for n in agg_nodes]]
    for node, desc in reversed(q.order_by):
        idx = _select_index(q, node)
        rows.sort(key=lambda r: (r[idx] is None, r[idx]), reverse=desc)
    if q.limit is not None:
        rows = rows[: q.limit]
    return [[float(v) if isinstance(v, Fraction) else v for v in r] for r in rows]


def _agg_value(op: str, a: dict, g: int):
    """One aggregate's exact value (SUM of no rows 0, AVG, MIN, MAX None)."""
    count = a["count"][g]
    if op == "COUNT" or not count:
        return count if op in ("COUNT", "SUM") else None
    unit = Fraction(1, 10 ** a["scale"])
    if op == "SUM":
        return a["sum"][g] * unit
    if op == "AVG":
        return a["sum"][g] * unit / count
    return a[op.lower()][g] * unit


def _select_index(q: Query, node: Node) -> int:
    for i, (sel, name) in enumerate(q.select):
        if sel == node or (node.kind == "col" and name == node.value):
            return i
    raise ValueError(f"ORDER BY {node} is not a select item")


def _range_split(q: Query, table):
    """Where the WHERE is a conjunction with range conjuncts on one
    dictionary column: (what the queries that can share a pass have in
    common, its ranges [(op, literal)]); else (None, [])."""
    if q.where is None:
        return None, []
    conj: list[Node] = []

    def walk(n: Node):
        if n.kind == "and":
            walk(n.args[0]), walk(n.args[1])
        else:
            conj.append(n)

    walk(q.where)
    ranges, rest, column = [], [], None
    for n in conj:
        target = None
        if n.kind == "cmp" and n.op in ("<", "<=", ">", ">=") and n.args[0].kind == "col" and n.args[1].kind in ("num", "str"):
            target = n.args[0].value
            pieces = [(n.op, n.args[1])]
        elif n.kind == "between" and n.args[0].kind == "col" and all(a.kind in ("num", "str") for a in n.args[1:]):
            target = n.args[0].value
            pieces = [(">=", n.args[1]), ("<=", n.args[2])]
        if target is not None and table.columns[target].dictionary is not None and column in (None, target):
            column = target
            ranges += pieces
        else:
            rest.append(n)
    if column is None:
        return None, []
    where = None
    for n in rest:
        where = n if where is None else Node("and", args=(where, n))
    shape = (tuple((n, name) for n, name in q.select), tuple(q.group_by), tuple(q.order_by), q.limit)
    return (column, where, shape), ranges
