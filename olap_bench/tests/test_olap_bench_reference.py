"""The reference against a row-by-row Python evaluation of the queries of
the traffic mix, at SF 0.01, and of each form it parses on a small table."""

from __future__ import annotations

from collections import defaultdict
from fractions import Fraction
from pathlib import Path

import pytest
import torch

from olap_bench.generators import tpch_lineitem
from olap_bench.reference.sql import Evaluator
from olap_bench.traffic import Traffic

HERE = Path(__file__).resolve().parents[1]
SEED = 2**31 + 23
CFG = {"scale_factor": 0.01, "rows": 59_986, "text_pool_bytes": 1 << 20}


def decoded_rows(table) -> list[dict]:
    cols = {}
    for name, col in table.columns.items():
        if col.dictionary is not None:
            cols[name] = [v.item() if hasattr(v, "item") else v for v in col.dictionary[col.data]]
        elif col.scale is not None:
            cols[name] = [Fraction(int(v), 10**col.scale) for v in col.data]
        else:
            cols[name] = [int(v) for v in col.data]
    return [dict(zip(cols, vals)) for vals in zip(*cols.values())]


def grouped(rows, where, key, aggs, order):
    """GROUP BY `key(row)` of the rows `where` keeps; `aggs`: name ->
    ("sum" | "avg" | "count", value(row)); rows out as [*key, *aggs], sorted by
    `order(out_row)` (a tuple)."""
    acc = defaultdict(lambda: defaultdict(Fraction))
    counts = defaultdict(int)
    for r in rows:
        if where(r):
            k = key(r)
            counts[k] += 1
            for name, (_, f) in aggs.items():
                if f is not None:
                    acc[k][name] += f(r)
    out = []
    for k, n in counts.items():
        vals = []
        for name, (kind, _) in aggs.items():
            vals.append(n if kind == "count" else acc[k][name] if kind == "sum" else acc[k][name] / n)
        out.append([*k, *vals])
    out.sort(key=order)
    return [[float(v) if isinstance(v, Fraction) else v for v in row] for row in out]


def q1_expected(rows, cutoff: str) -> list:
    one = Fraction(1)
    return grouped(
        rows,
        lambda r: r["l_shipdate"] <= cutoff,
        lambda r: (r["l_returnflag"], r["l_linestatus"]),
        {
            "sum_qty": ("sum", lambda r: r["l_quantity"]),
            "sum_base": ("sum", lambda r: r["l_extendedprice"]),
            "sum_disc": ("sum", lambda r: r["l_extendedprice"] * (one - r["l_discount"])),
            "sum_charge": ("sum", lambda r: r["l_extendedprice"] * (one - r["l_discount"]) * (one + r["l_tax"])),
            "avg_qty": ("avg", lambda r: r["l_quantity"]),
            "avg_price": ("avg", lambda r: r["l_extendedprice"]),
            "avg_disc": ("avg", lambda r: r["l_discount"]),
            "count": ("count", None),
        },
        lambda x: (x[0], x[1]),
    )


@pytest.fixture(scope="module")
def lineitem():
    return tpch_lineitem.generate(CFG, SEED, torch.device("cpu")).sorted_by("l_shipdate").to_host()


def test_tpch_q1_reference_equals_row_by_row(lineitem):
    traffic = Traffic.load(HERE / "traffic" / "tpch_q1.json")
    sqls = traffic.distinct()
    assert len(sqls) == 61
    got = Evaluator(lineitem).answer_all([sql for _, sql in sqls])
    rows = decoded_rows(lineitem)
    for _, sql in sqls[::12] + sqls[-1:]:
        cutoff = sql.split("l_shipdate <= '")[1][:10]
        assert got[sql] == q1_expected(rows, cutoff), cutoff


def test_reference_forms_on_a_small_table():
    """Each form the reference parses, against plain Python over the rows."""
    import numpy as np

    from olap_bench.table import Column, Table

    rng = np.random.default_rng(5)
    n = 2000
    cities = np.array(["ALGIERS", "BERN", "CAIRO", "DELHI"])
    t = Table(
        "t",
        {
            "city": Column("STRING", "dimension", rng.integers(0, 4, n).astype(np.int32), cities),
            "year": Column("INT", "dimension", rng.integers(0, 3, n).astype(np.int32), np.array([1996, 1997, 1998], dtype=np.int32)),
            "qty": Column("INT", "metric", rng.integers(1, 51, n).astype(np.int32)),
            "price": Column("DOUBLE", "metric", rng.integers(100, 100000, n).astype(np.int64), scale=2),
        },
    )
    rows = decoded_rows(t)
    ev = Evaluator(t)
    got = ev.answer(
        "SELECT city, MIN(qty), MAX(price * 2 - qty), AVG(price), COUNT(*) FROM t "
        "WHERE year IN (1996, 1998) AND NOT qty BETWEEN 10 AND 20 AND (city <> 'BERN' OR price > 500.5) "
        "GROUP BY city ORDER BY city DESC LIMIT 3"
    )
    keep = [r for r in rows if r["year"] in (1996, 1998) and not 10 <= r["qty"] <= 20 and (r["city"] != "BERN" or r["price"] > Fraction("500.5"))]
    want = []
    for c in sorted({r["city"] for r in keep}, reverse=True)[:3]:
        g = [r for r in keep if r["city"] == c]
        want.append(
            [
                c,
                float(min(r["qty"] for r in g)),
                float(max(r["price"] * 2 - r["qty"] for r in g)),
                float(sum(r["price"] for r in g) / len(g)),
                len(g),
            ]
        )
    assert got == want
    assert ev.answer("SELECT SUM(qty), COUNT(*) FROM t WHERE qty > 50") == [[0, 0]]
