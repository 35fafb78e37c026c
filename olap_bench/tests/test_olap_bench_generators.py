"""The generator at SF 0.01: dbgen's cardinalities, ranges and rules, and
the segments cut from it."""

from __future__ import annotations

import datetime as dt

import numpy as np
import pytest
import torch

from olap_bench import segments
from olap_bench.generators import tpch_lineitem
from olap_bench.table import retail_cents

SEED = 2**31 + 11
ROWS = 59_986
CFG = {"scale_factor": 0.01, "rows": ROWS, "text_pool_bytes": 1 << 20}


@pytest.fixture(scope="module")
def lineitem():
    return tpch_lineitem.generate(CFG, SEED, torch.device("cpu")).sorted_by("l_shipdate")


def values(table, name):
    col = table.columns[name]
    return col.dictionary[col.data] if col.dictionary is not None else col.data


def test_same_seed_same_table_other_seed_other_table():
    a = tpch_lineitem.generate(CFG, SEED, torch.device("cpu"))
    b = tpch_lineitem.generate(CFG, SEED, torch.device("cpu"))
    c = tpch_lineitem.generate(CFG, SEED + 1, torch.device("cpu"))
    assert all(torch.equal(a.columns[k].data, b.columns[k].data) for k in a.columns)
    assert not torch.equal(a.columns["l_extendedprice"].data, c.columns["l_extendedprice"].data)
    assert not torch.equal(a.columns["l_comment"].data, c.columns["l_comment"].data)
    # every seed makes the same number of rows and the same order sizes
    assert a.n_rows == c.n_rows == ROWS


def test_tpch_rules(lineitem):
    t = lineitem.to_host()
    assert "l_comment" not in t.columns  # the text stays on the device
    iso = lambda n: values(t, n).astype("U10")  # noqa: E731
    ship, commit, receipt = iso("l_shipdate"), iso("l_commitdate"), iso("l_receiptdate")
    assert (ship[1:] >= ship[:-1]).all()
    as_day = lambda a: np.array([dt.date.fromisoformat(x).toordinal() for x in a])  # noqa: E731
    s, c, r = as_day(ship), as_day(commit), as_day(receipt)
    assert ((r - s >= 1) & (r - s <= 30)).all()
    # ship and commit both count from one order date: ship - 121 <= order <= ship - 1, commit - 90 <= order <= commit - 30
    assert ((c - s) <= 89).all() and ((c - s) >= 30 - 121).all()
    assert s.min() >= dt.date(1992, 1, 2).toordinal() and s.max() <= dt.date(1998, 12, 1).toordinal()
    current = dt.date(1995, 6, 17).toordinal()
    flag, status = values(t, "l_returnflag"), values(t, "l_linestatus")
    assert set(flag[r <= current]) <= {"R", "A"} and set(flag[r > current]) == {"N"}
    assert set(status[s > current]) == {"O"} and set(status[s <= current]) == {"F"}
    cols = t.columns
    assert cols["l_quantity"].scale == 2 and cols["l_discount"].scale == 2
    q = cols["l_quantity"].data // 100
    assert q.min() == 1 and q.max() == 50
    assert cols["l_discount"].data.min() == 0 and cols["l_discount"].data.max() == 10
    assert cols["l_tax"].data.min() == 0 and cols["l_tax"].data.max() == 8
    part = cols["l_partkey"].data.astype(np.int64)
    assert (cols["l_extendedprice"].data == q * retail_cents(torch.from_numpy(part)).numpy()).all()
    n_supp = 100
    supp = cols["l_suppkey"].data
    choices = [(part + i * (n_supp // 4 + (part - 1) // n_supp)) % n_supp + 1 for i in range(4)]
    assert np.any([supp == c for c in choices], axis=0).all()
    assert set(values(t, "l_shipmode")) == set(tpch_lineitem.SHIPMODE)


def test_comments_are_dbgens_text(lineitem):
    chars = lineitem.columns["l_comment"].data
    assert chars.shape == (ROWS, 43) and chars.dtype == torch.uint8
    length = (chars > 0).sum(1)
    assert length.min() == 10 and length.max() == 43
    # NUL-padded: no character after the first NUL
    assert ((chars > 0).int().diff(dim=1) <= 0).all()
    text = [bytes(r[: n].tolist()).decode("ascii") for r, n in zip(chars[:2000], length[:2000].tolist())]
    vocabulary = {w for words, _ in tpch_lineitem.SENTENCE for phrase in words for w in phrase.split()}
    for t in text:
        inner = t.split()[1:-1]  # the first and the last word may be cut
        assert all(w.rstrip(".;:?!-") in vocabulary or w in vocabulary for w in inner), t
    # nearly every comment is a value of its own, as dbgen's from a pool much longer than a table's text
    assert len(set(text)) > 0.99 * len(text)


def test_text_dictionary_sorts_and_ids_on_the_device():
    rows = ["b", "ab", "a", "ab", "zz z", "a b", ""]
    chars = torch.zeros((len(rows), 5), dtype=torch.uint8)
    for i, r in enumerate(rows):
        chars[i, : len(r)] = torch.tensor(list(r.encode()), dtype=torch.uint8)
    ids, values = segments.text_dictionary(chars)
    assert list(values) == sorted(set(rows)) and values.dtype == np.dtype("<U5")
    assert [values[i] for i in ids] == rows and ids.dtype == np.int32


def test_segments_hold_the_table(lineitem):
    on_device = lineitem
    t = on_device.to_host()
    cuts = segments.bounds(t, 12, "l_shipdate")
    descs = segments.descriptions(on_device, t, cuts)
    assert [d["n_docs"] for d in descs] == [e - s for s, e in cuts]
    assert cuts[0][0] == 0 and cuts[-1][1] == t.n_rows and all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    # equal spans of the calendar, the same cut dates for every seed
    ship = t.columns["l_shipdate"]
    card = len(ship.dictionary)
    for k, (s, e) in enumerate(cuts):
        assert card * k // 12 <= ship.data[s:e].min() and ship.data[s:e].max() < card * (k + 1) // 12
    chars = on_device.columns["l_comment"].data
    for d, (s, e) in zip(descs, cuts):
        assert set(d["columns"]) == set(on_device.columns)
        for name, col in t.columns.items():
            cd = d["columns"][name]
            if col.dictionary is None:
                want = col.data[s:e] / 10**col.scale if col.scale is not None else col.data[s:e]
                assert (cd["forward"] == want).all()
                continue
            seg_values = cd["dictionary"][cd["forward"]]
            assert (seg_values == col.dictionary[col.data[s:e]]).all()
            assert list(cd["dictionary"]) == sorted(set(seg_values.tolist()))
            assert cd["stats"]["cardinality"] == len(cd["dictionary"])
        cd = d["columns"]["l_comment"]
        want = [bytes(r[r > 0].tolist()).decode() for r in chars[s:e]]
        assert list(cd["dictionary"][cd["forward"]]) == want
        assert list(cd["dictionary"]) == sorted(set(want))
        assert (cd["stats"]["min"], cd["stats"]["max"]) == (min(want), max(want))
        assert d["columns"]["l_shipdate"]["stats"]["sorted"]
