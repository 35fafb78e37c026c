"""SQL lexer + recursive-descent parser for the Pinot SQL subset.

Reference parity: CalciteSqlParser.compileToPinotQuery (pinot-common sql-utils,
used at BaseSingleStageBrokerRequestHandler.java:300). Pinot delegates to
Calcite's babel parser; here a hand-rolled parser covers the dialect the
engine executes:

    [SET key = value ;]*
    [EXPLAIN PLAN FOR]
    SELECT [DISTINCT] item [, item]*
    FROM relation (table | joins | subqueries — multistage engine)
    [WHERE boolfilter]
    [GROUP BY expr [, expr]*]
    [HAVING boolfilter]
    [ORDER BY expr [ASC|DESC] [, ...]]
    [LIMIT n [OFFSET m] | LIMIT m, n]
    [UNION/INTERSECT/EXCEPT [ALL] select]*

with arithmetic expressions, function calls (incl. COUNT(DISTINCT x),
agg FILTER (WHERE ...), window functions OVER (...)), BETWEEN / IN / LIKE /
REGEXP_LIKE / IS [NOT] NULL / IS [NOT] DISTINCT FROM predicates, CASE WHEN,
GAPFILL(...), quoted identifiers ("col" or `col`) and '' -escaped string
literals. SET options include enableNullHandling (null-skipping aggregations
+ three-valued WHERE), useMultistageEngine, and trace.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from pinot_tpu_torch.query.ast import (
    And,
    ArrayLiteral,
    Between,
    BinaryOp,
    CaseWhen,
    Compare,
    CompareOp,
    Expr,
    FilterExpr,
    FunctionCall,
    Identifier,
    In,
    IsNull,
    Like,
    Literal,
    Not,
    Or,
    JoinRel,
    PredicateFunction,
    OrderByItem,
    RegexpLike,
    Relation,
    SelectItem,
    SelectStatement,
    SetOpStatement,
    Star,
    SubqueryRef,
    TableRef,
    WindowFunction,
)


class SqlParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*"|`(?:[^`]|``)*`)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$.]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\+|-|\*|/|%|\(|\)|\[|\]|,|;)
    """,
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str  # number | string | ident | qident | op | eof
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlParseError(f"unexpected character {sql[pos]!r} at position {pos}")
        kind = m.lastgroup
        if kind != "ws":
            tokens.append(Token(kind, m.group(), pos))
        pos = m.end()
    tokens.append(Token("eof", "", pos))
    return tokens


_KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "LIKE", "IS",
    "NULL", "TRUE", "FALSE", "DISTINCT", "ASC", "DESC", "SET",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "UNION", "INTERSECT", "EXCEPT", "ALL", "OVER", "PARTITION",
}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            t = self.peek()
            raise SqlParseError(f"expected {kw} at position {t.pos}, got {t.text!r}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.text in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            t = self.peek()
            raise SqlParseError(f"expected {op!r} at position {t.pos}, got {t.text!r}")

    # -- entry --------------------------------------------------------------

    def parse(self) -> SelectStatement:
        options: dict[str, str] = {}
        # SET key = value; prefix statements (QueryOptionsUtils parity)
        while self.at_kw("SET"):
            self.next()
            key = self._identifier_name(self.next())
            self.expect_op("=")
            t = self.next()
            if t.kind == "string":
                val = _unquote_string(t.text)
            elif t.kind in ("number", "ident"):
                val = t.text
            else:
                raise SqlParseError(f"bad SET value at {t.pos}")
            options[key] = val
            self.expect_op(";")

        explain = False
        analyze = False
        if self.at_kw("EXPLAIN"):
            # EXPLAIN PLAN FOR <query> (CalciteSqlParser explain parity) or
            # EXPLAIN ANALYZE <query> (execute + stats-annotated plan tree)
            self.next()
            if self.eat_kw("ANALYZE"):
                analyze = True
            else:
                if not self.eat_kw("PLAN"):
                    raise SqlParseError("expected PLAN or ANALYZE after EXPLAIN")
                if not self.eat_kw("FOR"):
                    raise SqlParseError("expected FOR after EXPLAIN PLAN")
                explain = True
        stmt = self._query()
        stmt.options.update(options)
        if explain:
            stmt.explain = True
        if analyze:
            stmt.explain_analyze = True
        self.eat_op(";")
        t = self.peek()
        if t.kind != "eof":
            raise SqlParseError(f"unexpected trailing input at position {t.pos}: {t.text!r}")
        return stmt

    def _query(self):
        """select [UNION/INTERSECT/EXCEPT [ALL] select]* (left-associative)."""
        left = self._select_or_paren()
        while self.at_kw("UNION", "INTERSECT", "EXCEPT"):
            kind = self.next().upper.lower()
            all_ = self.eat_kw("ALL")
            right = self._select_or_paren()
            left = SetOpStatement(kind, all_, left, right)
        return left

    def _select_or_paren(self):
        if self.at_op("(") :
            self.next()
            inner = self._query()
            self.expect_op(")")
            return inner
        return self._select()

    # -- FROM relations -----------------------------------------------------

    _JOIN_STOP = {
        "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "ON", "WHERE",
        "GROUP", "HAVING", "ORDER", "LIMIT", "UNION", "INTERSECT", "EXCEPT",
    }

    def _maybe_alias(self) -> str | None:
        if self.eat_kw("AS"):
            return self._identifier_name(self.next())
        t = self.peek()
        if t.kind == "qident" or (t.kind == "ident" and t.upper not in _KEYWORDS):
            return self._identifier_name(self.next())
        return None

    def _relation_primary(self) -> Relation:
        if self.at_op("("):
            # subquery: ( SELECT ... ) alias
            self.next()
            inner = self._query()
            self.expect_op(")")
            alias = self._maybe_alias()
            if alias is None:
                raise SqlParseError(f"subquery requires an alias at position {self.peek().pos}")
            return SubqueryRef(inner, alias)
        name = self._identifier_name(self.next())
        alias = self._maybe_alias()
        return TableRef(name, alias)

    def _relation(self) -> Relation:
        left = self._relation_primary()
        while True:
            kind = None
            if self.at_kw("JOIN"):
                self.next()
                kind = "inner"
            elif self.at_kw("INNER") and self.peek(1).upper == "JOIN":
                self.next(); self.next()
                kind = "inner"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                kind = self.peek().upper.lower()
                self.next()
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
            elif self.at_kw("CROSS") and self.peek(1).upper == "JOIN":
                self.next(); self.next()
                kind = "cross"
            else:
                return left
            right = self._relation_primary()
            cond = None
            if kind != "cross":
                self.expect_kw("ON")
                cond = self._bool_expr()
            left = JoinRel(left, right, kind, cond)

    def _select(self) -> SelectStatement:
        self.expect_kw("SELECT")
        distinct = self.eat_kw("DISTINCT")
        items = [self._select_item()]
        while self.eat_op(","):
            items.append(self._select_item())
        self.expect_kw("FROM")
        relation = self._relation()
        table = relation.name if isinstance(relation, TableRef) and relation.alias is None else ""
        where = None
        if self.eat_kw("WHERE"):
            where = self._bool_expr()
        group_by: list[Expr] = []
        if self.at_kw("GROUP"):
            self.next()
            self.expect_kw("BY")
            group_by.append(self._expr())
            while self.eat_op(","):
                group_by.append(self._expr())
        having = None
        if self.eat_kw("HAVING"):
            having = self._bool_expr()
        order_by: list[OrderByItem] = []
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            order_by.append(self._order_item())
            while self.eat_op(","):
                order_by.append(self._order_item())
        limit = None
        offset = 0
        if self.eat_kw("LIMIT"):
            n1 = self._int_literal()
            if self.eat_op(","):  # LIMIT offset, limit (MySQL style)
                offset = n1
                limit = self._int_literal()
            else:
                limit = n1
                if self.eat_kw("OFFSET"):
                    offset = self._int_literal()
        return SelectStatement(
            select_list=items,
            from_table=table,
            distinct=distinct,
            where=where,
            group_by=group_by,
            having=having,
            order_by=order_by,
            limit=limit,
            offset=offset,
            relation=relation,
        )

    def _int_literal(self) -> int:
        t = self.next()
        if t.kind != "number" or not re.fullmatch(r"\d+", t.text):
            raise SqlParseError(f"expected integer at position {t.pos}")
        return int(t.text)

    def _select_item(self) -> SelectItem:
        expr = self._expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self._identifier_name(self.next())
        elif self.peek().kind in ("ident", "qident") and not self.at_kw(*_KEYWORDS):
            alias = self._identifier_name(self.next())
        return SelectItem(expr, alias)

    def _order_item(self) -> OrderByItem:
        expr = self._expr()
        desc = False
        if self.eat_kw("DESC"):
            desc = True
        else:
            self.eat_kw("ASC")
        return OrderByItem(expr, desc)

    def _window(self, fc: FunctionCall) -> WindowFunction:
        self.expect_kw("OVER")
        self.expect_op("(")
        partition_by: list[Expr] = []
        order_by: list[OrderByItem] = []
        if self.at_kw("PARTITION"):
            self.next()
            self.expect_kw("BY")
            partition_by.append(self._expr())
            while self.eat_op(","):
                partition_by.append(self._expr())
        if self.at_kw("ORDER"):
            self.next()
            self.expect_kw("BY")
            order_by.append(self._order_item())
            while self.eat_op(","):
                order_by.append(self._order_item())
        self.expect_op(")")
        return WindowFunction(fc, tuple(partition_by), tuple(order_by))

    def _array_element(self):
        neg = self.eat_op("-")
        t = self.next()
        if t.kind != "number":
            raise SqlParseError(f"ARRAY elements must be numeric literals at {t.pos}")
        v = int(t.text) if re.fullmatch(r"\d+", t.text) else float(t.text)
        return -v if neg else v

    def _identifier_name(self, t: Token) -> str:
        if t.kind == "ident":
            return t.text
        if t.kind == "qident":
            q = t.text[0]
            return t.text[1:-1].replace(q * 2, q)
        raise SqlParseError(f"expected identifier at position {t.pos}, got {t.text!r}")

    # -- boolean expressions ------------------------------------------------

    def _bool_expr(self) -> FilterExpr:
        return self._bool_or()

    def _bool_or(self) -> FilterExpr:
        left = self._bool_and()
        children = [left]
        while self.eat_kw("OR"):
            children.append(self._bool_and())
        return Or(tuple(children)) if len(children) > 1 else left

    def _bool_and(self) -> FilterExpr:
        left = self._bool_not()
        children = [left]
        while self.eat_kw("AND"):
            children.append(self._bool_not())
        return And(tuple(children)) if len(children) > 1 else left

    def _bool_not(self) -> FilterExpr:
        if self.eat_kw("NOT"):
            return Not(self._bool_not())
        return self._bool_primary()

    def _bool_primary(self) -> FilterExpr:
        # Parenthesized boolean vs parenthesized value expression: try boolean.
        if self.at_op("("):
            save = self.i
            self.next()
            try:
                inner = self._bool_expr()
                self.expect_op(")")
                return inner
            except SqlParseError:
                self.i = save  # fall through to predicate on value expr
        # REGEXP_LIKE(col, 'pattern') and TEXT_MATCH-style boolean functions
        if self.peek().kind == "ident" and self.peek().upper == "REGEXP_LIKE" and self.peek(1).text == "(":
            self.next()
            self.next()
            expr = self._expr()
            self.expect_op(",")
            pat = self.next()
            if pat.kind != "string":
                raise SqlParseError(f"REGEXP_LIKE pattern must be a string at {pat.pos}")
            self.expect_op(")")
            return RegexpLike(expr, _unquote_string(pat.text))
        if (
            self.peek().kind == "ident"
            and self.peek().text.lower() in _PREDICATE_FUNCS
            and self.peek(1).text == "("
        ):
            name = self.next().text.lower()
            self.next()
            args: list[Expr] = []
            if not self.at_op(")"):
                args.append(self._expr())
                while self.eat_op(","):
                    args.append(self._expr())
            self.expect_op(")")
            return PredicateFunction(name, tuple(args))
        return self._predicate()

    def _predicate(self) -> FilterExpr:
        left = self._expr()
        negated = self.eat_kw("NOT")
        if self.eat_kw("BETWEEN"):
            low = self._expr()
            self.expect_kw("AND")
            high = self._expr()
            return Between(left, low, high, negated)
        if self.eat_kw("IN"):
            self.expect_op("(")
            vals = [self._expr()]
            while self.eat_op(","):
                vals.append(self._expr())
            self.expect_op(")")
            return In(left, tuple(vals), negated)
        if self.eat_kw("LIKE"):
            pat = self.next()
            if pat.kind != "string":
                raise SqlParseError(f"LIKE pattern must be a string at {pat.pos}")
            return Like(left, _unquote_string(pat.text), negated)
        if negated:
            raise SqlParseError(f"expected BETWEEN/IN/LIKE after NOT at position {self.peek().pos}")
        if self.eat_kw("IS"):
            neg = self.eat_kw("NOT")
            if self.eat_kw("DISTINCT"):
                self.expect_kw("FROM")
                right = self._expr()
                from pinot_tpu_torch.query.ast import DistinctFrom

                return DistinctFrom(left, right, neg)
            if self.at_kw("TRUE") or self.at_kw("FALSE"):
                from pinot_tpu_torch.query.ast import BoolAssert

                want_true = self.at_kw("TRUE")
                self.next()
                return BoolAssert(left, want_true, neg)
            self.expect_kw("NULL")
            return IsNull(left, neg)
        for sym, op in (
            ("=", CompareOp.EQ), ("!=", CompareOp.NEQ), ("<>", CompareOp.NEQ),
            ("<=", CompareOp.LTE), (">=", CompareOp.GTE), ("<", CompareOp.LT), (">", CompareOp.GT),
        ):
            if self.eat_op(sym):
                right = self._expr()
                return Compare(op, left, right)
        t = self.peek()
        raise SqlParseError(f"expected predicate operator at position {t.pos}, got {t.text!r}")

    # -- value expressions --------------------------------------------------

    def _fn_arg(self) -> Expr:
        """A function argument: a value expression, optionally continued into
        a comparison predicate (funnel STEPS conditions: `url = '/cart'`)."""
        left = self._expr()
        for sym, op in (
            ("=", CompareOp.EQ), ("!=", CompareOp.NEQ), ("<>", CompareOp.NEQ),
            ("<=", CompareOp.LTE), (">=", CompareOp.GTE), ("<", CompareOp.LT), (">", CompareOp.GT),
        ):
            if self.eat_op(sym):
                from pinot_tpu_torch.query.ast import PredicateExpr

                return PredicateExpr(Compare(op, left, self._expr()))
        return left

    def _expr(self) -> Expr:
        return self._additive()

    def _additive(self) -> Expr:
        left = self._multiplicative()
        while self.at_op("+", "-"):
            op = self.next().text
            left = BinaryOp(op, left, self._multiplicative())
        return left

    def _multiplicative(self) -> Expr:
        left = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.next().text
            left = BinaryOp(op, left, self._unary())
        return left

    def _unary(self) -> Expr:
        if self.eat_op("-"):
            inner = self._unary()
            if isinstance(inner, Literal) and isinstance(inner.value, (int, float)):
                return Literal(-inner.value)
            return BinaryOp("-", Literal(0), inner)
        self.eat_op("+")
        return self._primary()

    def _primary(self) -> Expr:
        t = self.peek()
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self._expr()
            self.expect_op(")")
            return e
        if t.kind == "op" and t.text == "*":
            self.next()
            return Star()
        if t.kind == "number":
            self.next()
            if re.fullmatch(r"\d+", t.text):
                return Literal(int(t.text))
            return Literal(float(t.text))
        if t.kind == "string":
            self.next()
            return Literal(_unquote_string(t.text))
        if t.kind == "qident":
            self.next()
            return Identifier(self._identifier_name(t))
        if t.kind == "ident":
            up = t.upper
            if up == "ARRAY" and self.peek(1).text == "[":
                self.next()
                self.next()
                vals: list = []
                if not self.at_op("]"):
                    vals.append(self._array_element())
                    while self.eat_op(","):
                        vals.append(self._array_element())
                self.expect_op("]")
                return ArrayLiteral(tuple(vals))
            if up == "CASE":
                return self._case()
            if up == "NULL":
                self.next()
                return Literal(None)
            if up == "TRUE":
                self.next()
                return Literal(True)
            if up == "FALSE":
                self.next()
                return Literal(False)
            # function call?
            if self.peek(1).kind == "op" and self.peek(1).text == "(":
                if up == "CAST":
                    # CAST(expr AS TYPE) — AS + type token need special parsing
                    self.next()
                    self.next()
                    inner = self._expr()
                    self.expect_kw("AS")
                    ty = self._identifier_name(self.next())
                    self.expect_op(")")
                    return FunctionCall("cast", (inner, Literal(ty.upper())))
                if up == "EXTRACT":
                    # EXTRACT(unit FROM expr) — rewrites to the matching
                    # datetime extract function (ExtractTransformFunction)
                    self.next()
                    self.next()
                    unit = self._identifier_name(self.next()).upper()
                    fn = _EXTRACT_UNITS.get(unit)
                    if fn is None:
                        raise SqlParseError(f"unsupported EXTRACT unit {unit!r}")
                    self.expect_kw("FROM")
                    inner = self._expr()
                    self.expect_op(")")
                    return FunctionCall(fn, (inner,))
                self.next()
                self.next()
                distinct = self.eat_kw("DISTINCT")
                args: list[Expr] = []
                if not self.at_op(")"):
                    args.append(self._fn_arg())
                    while self.eat_op(","):
                        args.append(self._fn_arg())
                self.expect_op(")")
                fc = FunctionCall(_FUNC_ALIASES.get(t.text.lower(), t.text.lower()), tuple(args), distinct)
                if self.at_kw("FILTER"):
                    # agg(x) FILTER (WHERE cond) — FilteredAggregationFunction
                    self.next()
                    self.expect_op("(")
                    self.expect_kw("WHERE")
                    cond = self._bool_expr()
                    self.expect_op(")")
                    fc = FunctionCall(fc.name, fc.args, fc.distinct, cond)
                if self.at_kw("OVER"):
                    return self._window(fc)
                return fc
            self.next()
            return Identifier(t.text)
        raise SqlParseError(f"unexpected token {t.text!r} at position {t.pos}")

    def _case(self) -> Expr:
        """CASE [operand] WHEN ... THEN ... [ELSE ...] END. The simple form
        (with operand) desugars into equality compares on the operand."""
        self.next()  # CASE
        operand = None
        if not self.at_kw("WHEN"):
            operand = self._expr()
        whens: list[tuple] = []
        while self.eat_kw("WHEN"):
            if operand is None:
                cond: FilterExpr = self._bool_expr()
            else:
                cond = Compare(CompareOp.EQ, operand, self._expr())
            self.expect_kw("THEN")
            whens.append((cond, self._expr()))
        if not whens:
            t = self.peek()
            raise SqlParseError(f"CASE requires at least one WHEN at position {t.pos}")
        else_ = None
        if self.eat_kw("ELSE"):
            else_ = self._expr()
        self.expect_kw("END")
        return CaseWhen(tuple(whens), else_)


def _unquote_string(s: str) -> str:
    return s[1:-1].replace("''", "'")


# Boolean index-probe functions accepted in WHERE position (parity:
# Pinot's TEXT_MATCH / JSON_MATCH / VECTOR_SIMILARITY filter functions).
_PREDICATE_FUNCS = {"text_match", "json_match", "vector_similarity", "st_within_distance"}


# SQL-name aliases for registry names (Pinot accepts several spellings of
# the sketch aggregations; the registry uses one canonical name each)
#: EXTRACT(unit FROM ts) -> datetime extract function (ExtractTransformFunction
#: unit set, core/operator/transform/function/ExtractTransformFunction.java)
_EXTRACT_UNITS = {
    "YEAR": "year",
    "QUARTER": "quarter",
    "MONTH": "month",
    "WEEK": "week",
    "DAY": "dayofmonth",
    "DAY_OF_MONTH": "dayofmonth",
    "DOW": "dayofweek",
    "DAY_OF_WEEK": "dayofweek",
    "DOY": "dayofyear",
    "DAY_OF_YEAR": "dayofyear",
    "HOUR": "hour",
    "MINUTE": "minute",
    "SECOND": "second",
    "MILLISECOND": "millisecond",
}

_FUNC_ALIASES = {
    "distinctcountthetasketch": "distinctcounttheta",
    "distinct_count_theta_sketch": "distinctcounttheta",
    "funnel_count": "funnelcount",
    "funnel_complete_count": "funnelcompletecount",
    "funnel_max_step": "funnelmaxstep",
    "funnel_match_step": "funnelmatchstep",
    "funnel_step_duration_stats": "funnelstepdurationstats",
}


def parse_sql(sql: str) -> SelectStatement:
    """Parse a SQL string into a SelectStatement AST."""
    return Parser(sql).parse()
