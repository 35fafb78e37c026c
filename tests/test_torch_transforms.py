"""Unit parity of the port's transform registry (query/transforms.py) with
the JAX package's: every DEVICE_FUNCS entry evaluated with numpy on seeded
inputs, every STRING_FUNCS entry through `apply_string_func`, and each one
in SQL through both host executors (both forced to the host), one case per
name. Values must be equal (NaN equal to NaN), with the reference's Python
types in the SQL rows."""

import base64
import json

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import transforms as jtr
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import transforms as tr
from pinot_tpu_torch.segment import SegmentBuilder
from test_torch_host_exec import _assert_same, _forced_host

DATETIME = {
    "year", "month", "dayofmonth", "hour", "minute", "second", "millissinceepoch", "millisecond", "dayofweek",
    "dayofyear", "quarter", "week", "weekofyear",
}


def _data(seed, n):
    rng = np.random.default_rng(seed)
    words = np.asarray([" ab12 ", "b x/3", "Zeta9", "", "a%20b", "éclair7", "ab"], dtype=object)
    s = words[rng.integers(0, len(words), n)]
    return {
        "s": s,
        "b64": np.asarray([base64.b64encode(str(v).encode()).decode() for v in s], dtype=object),
        "js": np.asarray([json.dumps({"a": int(i), "b": {"c": str(i)}}) for i in rng.integers(-5, 50, n)], dtype=object),
        "ms": rng.integers(-315_619_200_000, 2_000_000_000_000, n).astype(np.int64),
        "x": np.round(rng.uniform(0.05, 0.95, n), 4),
        "y": np.round(rng.normal(0, 3, n), 4),
        "i": rng.integers(-40, 40, n).astype(np.int32),
        "lat": np.round(rng.uniform(-60, 60, n), 5),
        "lng": np.round(rng.uniform(-170, 170, n), 5),
    }


def _schema(DT, S):
    return S.build(
        "t",
        dimensions=[("s", DT.STRING), ("b64", DT.STRING), ("js", DT.STRING), ("i", DT.INT)],
        metrics=[("x", DT.DOUBLE), ("y", DT.DOUBLE), ("lat", DT.DOUBLE), ("lng", DT.DOUBLE)],
        date_times=[("ms", DT.LONG)],
    )


@pytest.fixture(scope="module")
def engines():
    datas = [_data(41 + i, n) for i, n in enumerate([300, 200])]
    ref = JEngine([JBuilder(_schema(JDT, JSchema)).build(d, f"t{i}") for i, d in enumerate(datas)])
    port = QueryEngine([SegmentBuilder(_schema(DataType, Schema)).build(d, f"t{i}") for i, d in enumerate(datas)],
                       device="cpu")
    return ref, port


def _device_args(name: str, arity: int) -> list[str]:
    """The SQL arguments of one DEVICE_FUNCS call over the table's columns."""
    if name in DATETIME or name.startswith("datetrunc_"):
        return ["ms"]
    if name == "st_distance":
        return ["lat", "lng", "37.5", "-122.25"]
    if name in ("rounddecimal", "truncate"):
        return ["y", "2"]
    if name == "mod":
        return ["i", "7"]
    if arity == 2:
        return ["y", "x"]
    if name in ("asin", "acos", "log", "ln", "log2", "log10", "sqrt", "cot"):
        return ["x"]
    return ["y"]


@pytest.mark.parametrize("name", sorted(tr.DEVICE_FUNCS))
def test_device_function_matches_reference(engines, monkeypatch, name):
    assert name in jtr.DEVICE_FUNCS
    arity, fn = tr.DEVICE_FUNCS[name]
    assert arity == jtr.DEVICE_FUNCS[name][0]
    data = _data(7, 400)
    args = [data[a] if a in data else np.full(400, float(a)) for a in _device_args(name, arity)]
    got = np.asarray(fn(np, *args))
    want = np.asarray(jtr.DEVICE_FUNCS[name][1](np, *args))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref, port = engines
    _forced_host(monkeypatch)
    sql = f"SELECT {name}({', '.join(_device_args(name, arity))}), i FROM t WHERE i > -30 LIMIT 40"
    _assert_same(port.execute(sql), ref.execute(sql), sql)


#: name -> (column, literal args)
STRING_ARGS = {
    "substr": ("s", (1, 3)),
    "replace": ("s", ("a", "Z")),
    "concat": ("s", ("_x",)),
    "startswith": ("s", ("a",)),
    "endswith": ("s", ("2",)),
    "lpad": ("s", (8, "*")),
    "rpad": ("s", (8, "-")),
    "strpos": ("s", ("b",)),
    "repeat": ("s", (2,)),
    "remove": ("s", ("a",)),
    "frombase64": ("b64", ()),
    "regexpreplace": ("s", ("[aeiou]", "#")),
    "regexpextract": ("s", ("([a-z]+)(\\d+)", 2)),
    "jsonextractscalar": ("js", ("$.a", "INT")),
}


def _sql_lit(v) -> str:
    return f"'{v}'" if isinstance(v, str) else str(v)


@pytest.mark.parametrize("name", sorted(tr.STRING_FUNCS))
def test_string_function_matches_reference(engines, monkeypatch, name):
    assert tr.STRING_FUNCS[name][0] == jtr.STRING_FUNCS[name][0]
    col, args = STRING_ARGS.get(name, ("s", ()))
    values = _data(8, 200)[col]
    got, got_str = tr.apply_string_func(name, values, args)
    want, want_str = jtr.apply_string_func(name, values, args)
    assert got_str == want_str and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    ref, port = engines
    _forced_host(monkeypatch)
    call = f"{name}({', '.join([col] + [_sql_lit(a) for a in args])})"
    for sql in (f"SELECT {call}, i FROM t LIMIT 30", f"SELECT {call}, COUNT(*) FROM t GROUP BY {call} ORDER BY {call} LIMIT 50"):
        _assert_same(port.execute(sql), ref.execute(sql), sql)


@pytest.mark.parametrize(
    "call",
    [
        "TIMECONVERT(ms, 'MILLISECONDS', 'DAYS')",
        "TIMECONVERT(ms, 'MILLISECONDS', 'HOURS')",
        "DATETIMECONVERT(ms, '1:MILLISECONDS:EPOCH', '1:MINUTES:EPOCH', '15:MINUTES')",
    ],
)
def test_time_convert_matches_reference(engines, monkeypatch, call):
    """The TIMECONVERT / DATETIMECONVERT rewrite: the same AST in both
    packages, the same values on the host."""
    from pinot_tpu.query.sql import parse_sql as jparse
    from pinot_tpu_torch.query.sql import parse_sql

    want = jtr.rewrite_time_convert(jparse(f"SELECT {call} FROM t").select_list[0].expr)
    got = tr.rewrite_time_convert(parse_sql(f"SELECT {call} FROM t").select_list[0].expr)
    assert repr(got) == repr(want)
    ref, port = engines
    _forced_host(monkeypatch)
    sql = f"SELECT {call}, COUNT(*) FROM t GROUP BY {call} ORDER BY {call} LIMIT 20"
    _assert_same(port.execute(sql), ref.execute(sql), sql)


def test_registered_functions_run_on_the_host(engines, monkeypatch):
    """register_* puts a user function in the registries both executors
    read; unregister_function takes it out."""
    ref, port = engines
    for mod in (tr, jtr):
        mod.register_device_function("twice_plus", 2, lambda xp, a, b: a * 2 + b)
        mod.register_string_function("first_char", (0,), lambda v: v[:1], True)
    try:
        with pytest.raises(ValueError, match="already registered"):
            tr.register_device_function("twice_plus", 1, lambda xp, a: a)
        _forced_host(monkeypatch)
        sql = "SELECT twice_plus(i, y), first_char(s) FROM t LIMIT 25"
        _assert_same(port.execute(sql), ref.execute(sql), sql)
    finally:
        for mod in (tr, jtr):
            mod.unregister_function("twice_plus")
            mod.unregister_function("first_char")
    assert "twice_plus" not in tr.DEVICE_FUNCS and "first_char" not in tr.STRING_FUNCS
