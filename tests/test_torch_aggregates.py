"""Unit parity of the port's aggregation modules with the JAX package's, on
seeded numpy inputs: every `aggregates.EXT_AGGS` function's compute (two
segments' partials), merge, finalize and empty partial, and the sketch
functions (t-digest, KLL, HLL++, UltraLogLog, CPC, the PERCENTILEEST
histogram, `exact_percentile`). One case per name. Partials and results must
be equal: the port's modules are the reference's, carried over."""

import numpy as np
import pytest

from pinot_tpu.query import aggregates as jagg
from pinot_tpu.query import distinct_sketch as jds
from pinot_tpu.query import quantile_sketch as jqs
from pinot_tpu.query import sketches as jsk
from pinot_tpu_torch.query import aggregates as agg
from pinot_tpu_torch.query import distinct_sketch as ds
from pinot_tpu_torch.query import quantile_sketch as qs
from pinot_tpu_torch.query import sketches as sk
from pinot_tpu_torch.query.context import QueryContext
from test_torch_host_exec import EXT_CALLS, _m_data


def _eq(a, b) -> bool:
    """Deep equality over partials: arrays by dtype and value (NaN equal),
    containers element by element."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == object:
            return all(_eq(x, y) for x, y in zip(a.tolist(), b.tolist()))
        return bool(np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"))
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, float):
        return a == b or (a != a and b != b)
    return a == b


def test_ext_aggs_are_the_references():
    assert sorted(agg.EXT_AGGS) == sorted(jagg.EXT_AGGS)
    assert agg.TWO_ARG_AGGS == jagg.TWO_ARG_AGGS


@pytest.mark.parametrize("name", sorted(EXT_CALLS))
def test_ext_agg_matches_reference(name):
    info = QueryContext.from_sql(f"SELECT {EXT_CALLS[name]} FROM m").aggregations[0]
    port, ref = agg.EXT_AGGS[name], jagg.EXT_AGGS[name]
    parts = []
    for seed, n in ((1, 400), (2, 300), (3, 0)):
        d = _m_data(seed, n)
        v = d[info.arg.name]
        v2 = d[info.arg2.name] if info.arg2 is not None else None
        p, r = port.compute(v, v2, info.extra), ref.compute(v, v2, info.extra)
        assert _eq(p, r), (name, seed)
        parts.append((p, r))
    p, r = parts[0]
    for pp, rr in parts[1:]:
        p, r = port.merge(p, pp), ref.merge(r, rr)
        assert _eq(p, r), name
    assert _eq(port.finalize(p, info.extra), ref.finalize(r, info.extra)), name
    e_p, e_r = port.empty(info.extra), ref.empty(info.extra)
    assert _eq(e_p, e_r), name
    assert _eq(port.finalize(port.merge(e_p, parts[0][0]), info.extra), ref.finalize(ref.merge(e_r, parts[0][1]), info.extra))


def _values(seed, n=5000, kind="f"):
    rng = np.random.default_rng(seed)
    if kind == "f":
        return np.round(rng.normal(100, 30, n), 3)
    if kind == "i":
        return rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    return np.asarray([f"u{i}" for i in rng.integers(0, 3000, n)], dtype=object)


#: name -> fn(module of distinct_sketch, quantile_sketch, sketches, aggregates)
SKETCH_CASES = {
    "hash64": lambda d, q, s, a: [d.hash64(_values(k, 2000, t)) for k, t in ((1, "f"), (2, "i"), (3, "s"))],
    "hllplus": lambda d, q, s, a: _distinct(d.hllplus_registers, d.hllplus_merge, d.hllplus_estimate),
    "hllplus_p10": lambda d, q, s, a: _distinct(lambda v: d.hllplus_registers(v, 10), d.hllplus_merge, d.hllplus_estimate),
    "ull": lambda d, q, s, a: _distinct(d.ull_registers, d.ull_merge, d.ull_estimate),
    "cpc": lambda d, q, s, a: _distinct(d.cpc_matrix, d.cpc_merge, d.cpc_estimate),
    "td_create": lambda d, q, s, a: [q.td_create(), q.td_create(50.0)],
    "td_from_values": lambda d, q, s, a: [q.td_from_values(_values(4)), q.td_from_values(_values(5, 300), 50.0)],
    "td_merge": lambda d, q, s, a: q.td_merge(q.td_from_values(_values(6)), q.td_from_values(_values(7, 900))),
    "td_quantile": lambda d, q, s, a: [
        q.td_quantile(q.td_merge(q.td_from_values(_values(8)), q.td_from_values(_values(9))), p)
        for p in (0, 1, 25, 50, 95, 99.9, 100)
    ],
    "td_serialize": lambda d, q, s, a: [
        q.td_serialize(q.td_from_values(_values(10))),
        q.td_deserialize(q.td_serialize(q.td_from_values(_values(11)))),
    ],
    "kll_create": lambda d, q, s, a: [q.kll_create(), q.kll_create(64)],
    "kll_from_values": lambda d, q, s, a: [q.kll_from_values(_values(12)), q.kll_from_values(_values(13, 100), 16)],
    "kll_merge": lambda d, q, s, a: q.kll_merge(q.kll_from_values(_values(14)), q.kll_from_values(_values(15, 700))),
    "kll_quantile": lambda d, q, s, a: [
        q.kll_quantile(q.kll_merge(q.kll_from_values(_values(16)), q.kll_from_values(_values(17))), p)
        for p in (0, 10, 50, 90, 100)
    ],
    "kll_serialize": lambda d, q, s, a: [
        q.kll_serialize(q.kll_from_values(_values(18))),
        q.kll_deserialize(q.kll_serialize(q.kll_from_values(_values(19)))),
    ],
    "np_est_hist": lambda d, q, s, a: [s.np_est_hist(_values(20), 0.0, 200.0), s.np_est_hist(_values(21), 5.0, 5.0)],
    "hist_estimate": lambda d, q, s, a: [
        s.hist_estimate(s.np_est_hist(_values(22), 0.0, 250.0), 0.0, 250.0, p) for p in (0, 5, 50, 95, 100)
    ] + [s.hist_estimate(np.zeros(s.EST_BINS, np.int64), 0.0, 1.0, 50)],
    "exact_percentile": lambda d, q, s, a: [a.exact_percentile(_values(23, 777), p) for p in (0, 33, 50, 95, 100)]
    + [a.exact_percentile(np.zeros(0), 50)],
}


def _distinct(build, merge, estimate):
    ra, rb = build(_values(30, 4000, "i")), build(_values(31, 3000, "s"))
    m = merge(ra, rb)
    return [ra, rb, m, estimate(m), estimate(build(np.zeros(0)))]


@pytest.mark.parametrize("name", sorted(SKETCH_CASES))
def test_sketch_function_matches_reference(name):
    fn = SKETCH_CASES[name]
    assert _eq(fn(ds, qs, sk, agg), fn(jds, jqs, jsk, jagg)), name
