"""SELECTION, SELECTION ORDER BY and DISTINCT in the port against the JAX
package, drawn from tests/test_query_fuzz.py (test_fuzz_selection_order_by,
test_fuzz_distinct) and the selection cases of tests/test_queries.py: the
same SQL over the same segments (built by each package, and the reference's
carried across) must give the same rows in the same order, with the same
Python types, and the same numDocsScanned. Covered: ties under ASC and DESC,
a DOUBLE key with NaN, +-0.0 and +-inf, LIMIT past the matched rows, OFFSET,
a multi-key composite ORDER BY, $docId / $segmentName, SELECT *, DISTINCT
with and without ORDER BY, and segments with no matching rows.

Also the pieces on their own: `top_k_stable` (with `total_order_key`)
against lax.top_k, `first_k` against jnp.nonzero(size=k), and
`sort_nulls_largest` against the reference's pandas version. Tolerance:
exact equality everywhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.sorting import sort_nulls_largest as jsort_nulls_largest
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.common.sorting import sort_nulls_largest
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_segment import describe

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]


def _data(seed, n, years):
    rng = np.random.default_rng(seed)
    disc = np.round(rng.uniform(-0.1, 0.1, n), 2)  # about 20 docs a value
    special = rng.choice([np.nan, 0.0, -0.0, np.inf, -np.inf], n)
    pick = rng.random(n) < 0.08
    disc[pick] = special[pick]
    return {
        "region": np.array(REGIONS, dtype=object)[rng.integers(0, 5, n)],
        "year": rng.choice(np.asarray(years, dtype=np.int32), n),
        "rating": np.where(rng.random(n) < 0.05, np.nan, np.round(rng.uniform(0, 5, n), 1)),
        "quantity": rng.integers(1, 11, n).astype(np.int32),  # heavy ties
        "revenue": rng.integers(-1000, 600_000, n).astype(np.int64),
        "discount": disc,
    }


def _schema(DT, S):
    return S.build(
        "t",
        dimensions=[("region", DT.STRING), ("year", DT.INT), ("rating", DT.DOUBLE)],
        metrics=[("quantity", DT.INT), ("revenue", DT.LONG), ("discount", DT.DOUBLE)],
    )


@pytest.fixture(scope="module")
def engines():
    # segment 1 holds no 1998 doc, segment 3 is a single doc
    datas = [
        _data(31, 3000, range(1992, 1999)),
        _data(32, 2000, range(1992, 1998)),
        _data(33, 2500, range(1992, 1999)),
        _data(34, 1, [1995]),
    ]
    jsegs = [JBuilder(_schema(JDT, JSchema)).build(d, f"t{i}") for i, d in enumerate(datas)]
    built = [SegmentBuilder(_schema(DataType, Schema)).build(d, f"t{i}") for i, d in enumerate(datas)]
    carried = [segment_from_numpy(describe(s)) for s in jsegs]
    return JEngine(jsegs), {"built": QueryEngine(built, device="cpu"), "carried": QueryEngine(carried, device="cpu")}


QUERIES = [
    # SELECTION: the first matching docs, segment by segment
    "SELECT region, year, quantity FROM t WHERE quantity = 3 LIMIT 12",
    "SELECT region, revenue, discount FROM t WHERE year = 1998 LIMIT 5000",  # past the matched rows
    "SELECT $docId, $segmentName, quantity FROM t WHERE revenue < 0 LIMIT 40",
    "SELECT * FROM t WHERE region = 'ASIA' AND quantity > 8 LIMIT 15",
    "SELECT quantity * 2, revenue - 1, revenue / quantity FROM t WHERE year = 1996 LIMIT 8 OFFSET 5",
    "SELECT region FROM t WHERE region = 'ATLANTIS' LIMIT 5",
    "SELECT year, rating FROM t LIMIT 10",
    # SELECTION ORDER BY: ties (quantity), ASC and DESC
    "SELECT region, quantity, $docId FROM t ORDER BY quantity LIMIT 30",
    "SELECT region, quantity, $docId FROM t ORDER BY quantity DESC LIMIT 30",
    "SELECT revenue, quantity FROM t WHERE region = 'EUROPE' ORDER BY quantity DESC LIMIT 10 OFFSET 25",
    "SELECT region, year FROM t WHERE year = 1998 ORDER BY region DESC LIMIT 20",  # a dict-id key
    # a DOUBLE key with NaN, +-0.0 and +-inf; LIMIT past the matched rows
    "SELECT discount, $docId FROM t ORDER BY discount DESC LIMIT 25",
    "SELECT discount, $docId FROM t ORDER BY discount LIMIT 25",
    "SELECT discount, year FROM t WHERE quantity = 7 AND region = 'AFRICA' ORDER BY discount LIMIT 5000",
    "SELECT discount, year FROM t WHERE quantity = 7 AND region = 'AFRICA' ORDER BY discount DESC LIMIT 5000",
    "SELECT rating, region FROM t WHERE quantity < 3 ORDER BY rating DESC LIMIT 40",  # NaN in a dictionary
    "SELECT revenue, quantity FROM t ORDER BY revenue / quantity DESC LIMIT 7",  # an expression key
    # a multi-key composite ORDER BY (dict ids and a raw int with an offset)
    "SELECT region, year, quantity, revenue FROM t ORDER BY region DESC, year, quantity DESC LIMIT 30",
    "SELECT region, quantity FROM t WHERE year >= 1997 ORDER BY quantity, region LIMIT 20 OFFSET 10",
    "SELECT $docId, year, revenue FROM t ORDER BY year DESC, revenue LIMIT 12",
    # DISTINCT, with and without ORDER BY
    "SELECT DISTINCT region FROM t",
    "SELECT DISTINCT region, year FROM t WHERE quantity = 10 LIMIT 500",
    "SELECT DISTINCT region, year FROM t WHERE quantity = 10 ORDER BY year DESC, region LIMIT 17",
    "SELECT DISTINCT year, rating FROM t WHERE quantity = 2 ORDER BY rating DESC, year LIMIT 12 OFFSET 3",
    "SELECT DISTINCT rating FROM t WHERE region = 'ASIA' ORDER BY rating DESC LIMIT 10",
    "SELECT DISTINCT year FROM t WHERE year = 1998 ORDER BY year",
    "SELECT DISTINCT region FROM t WHERE region = 'ATLANTIS'",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", QUERIES)
def test_selection_matches_reference(engines, sql, mode):
    ref, ports = engines
    want, got = ref.execute(sql), ports[mode].execute(sql)
    assert got.columns == want.columns
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        assert [type(v) for v in g] == [type(v) for v in w], (g, w)
        assert all(a == b or (a != a and b != b) for a, b in zip(g, w)), (g, w)
    assert got.num_docs_scanned == want.num_docs_scanned


def test_segment_without_matches_gives_an_empty_frame(engines):
    _, ports = engines
    port = ports["built"]
    ctx = port.make_context("SELECT region, quantity FROM t WHERE year = 1998 ORDER BY quantity LIMIT 5")
    frames = [port._execute_segment(seg, ctx) for seg in port.segments]
    assert [m for _, m in frames][1] == 0
    assert all(len(v) == 0 for v in frames[1][0].values())


# ---------------------------------------------------------------------------
# the device steps and the sort on their own
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 64, 500, 1000])
def test_top_k_stable_matches_lax_top_k(k):
    """Many ties (30 distinct keys over 1000 docs), special float values and
    k up to n: the same indices in the same order as lax.top_k."""
    rng = np.random.default_rng(k)
    x = rng.choice(np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5] + list(range(22)), float), 1000)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
    got = K.top_k_stable(K.total_order_key(torch.from_numpy(x)), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [0, 1, 7, 300, 2000])
def test_first_k_matches_nonzero(k):
    rng = np.random.default_rng(40 + k)
    mask = rng.random(1500) < 0.1
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=k, fill_value=0)[0])
    got = K.first_k(torch.from_numpy(mask), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ascending", [[True], [False], [True, False], [False, True, False]])
def test_sort_nulls_largest_matches_reference(ascending):
    rng = np.random.default_rng(len(ascending) * 7 + ascending[0])
    n = 400
    cols = {
        "f": np.where(rng.random(n) < 0.1, np.nan, rng.integers(0, 6, n).astype(float)),
        "s": np.array(["b", "a", "c", "aa"], dtype=object)[rng.integers(0, 4, n)],
        "i": rng.integers(-3, 3, n).astype(np.int64),
    }
    by = ["f", "s", "i"][: len(ascending)]
    want = jsort_nulls_largest(pd.DataFrame(cols), by, ascending).index.to_numpy()
    got = sort_nulls_largest([cols[c] for c in by], ascending)
    np.testing.assert_array_equal(got, want)
