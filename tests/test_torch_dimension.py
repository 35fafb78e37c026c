"""The port's dimension tables and lookUp() against the JAX package's (mirrors
tests/test_dimension.py): the same fact and dimension segments through both
packages' controllers and brokers; lookUp's rows must be equal (exact), as
must its errors and the manager's misses. lookUp runs in the host executor:
it launches no kernel."""

import numpy as np
import pytest

import pinot_tpu.cluster as rc
from pinot_tpu.cluster import dimension as rdim
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder
from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
from pinot_tpu_torch.cluster.dimension import DimensionTableDataManager, get_dim_table, unregister_dim_table
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder

ORDERS = {"cust_id": np.array([1, 2, 3, 1, 9], dtype=np.int32), "amount": np.array([10, 20, 30, 40, 50], dtype=np.int64)}
CUSTOMERS = {
    "cust_id": np.array([1, 2, 3], dtype=np.int32),
    "nation": np.array(["US", "FR", "JP"], dtype=object),
    "credit": np.array([100, 200, 300], dtype=np.int64),
}
CUSTOMERS_1 = {
    "cust_id": np.array([2, 4], dtype=np.int32),
    "nation": np.array(["DE", "BR"], dtype=object),
    "credit": np.array([250, 400], dtype=np.int64),
}
QUERIES = [
    "SELECT cust_id, LOOKUP('customers', 'nation', 'cust_id', cust_id), amount FROM orders LIMIT 10",
    "SELECT SUM(LOOKUP('customers', 'credit', 'cust_id', cust_id)) FROM orders WHERE cust_id <= 3",
    "SELECT LOOKUP('customers', 'nation', 'cust_id', cust_id), SUM(amount) FROM orders "
    "GROUP BY LOOKUP('customers', 'nation', 'cust_id', cust_id) ORDER BY SUM(amount) DESC",
]


def _setup(pkg, controller):
    dt, sch_cls, tc, sb = pkg
    fact = sch_cls.build("orders", dimensions=[("cust_id", dt.INT)], metrics=[("amount", dt.LONG)])
    controller.add_schema(fact)
    controller.add_table(tc("orders"))
    controller.upload_segment("orders", sb(fact).build(ORDERS, "orders_0"))
    dim = sch_cls.build(
        "customers",
        dimensions=[("cust_id", dt.INT), ("nation", dt.STRING)],
        metrics=[("credit", dt.LONG)],
        primary_key_columns=["cust_id"],
    )
    controller.add_schema(dim)
    cfg = tc("customers")
    cfg.extra = {"isDimTable": True}
    controller.add_table(cfg)
    controller.upload_segment("customers", sb(dim).build(CUSTOMERS, "customers_0"))


@pytest.fixture
def clusters(tmp_path):
    port = Controller(PropertyStore(), tmp_path / "ds")
    port.register_server("s0", Server("s0", device="cpu"))
    _setup((DataType, Schema, TableConfig, SegmentBuilder), port)
    ref = rc.Controller(rc.PropertyStore(), tmp_path / "ref_ds")
    ref.register_server("s0", rc.Server("s0"))
    _setup((RDataType, RSchema, RTableConfig, RSegmentBuilder), ref)
    yield port, ref
    unregister_dim_table("customers")
    rdim.unregister_dim_table("customers")


def test_dim_table_registered_and_refreshed(clusters):
    port, _ = clusters
    dim = get_dim_table("customers")
    assert dim.size == 3
    assert dim.lookup((2,))["nation"] == "FR"
    port.upload_segment("customers", SegmentBuilder(port.get_schema("customers")).build(CUSTOMERS_1, "customers_1"))
    dim = get_dim_table("customers")
    assert dim.size == 4
    assert dim.lookup((2,))["nation"] == "DE"  # refresh: later rows win per PK


@pytest.mark.parametrize("sql", QUERIES)
def test_lookup_rows_equal_reference(clusters, sql):
    port, ref = clusters
    broker = Broker(port)
    try:
        assert broker.execute(sql).rows == rc.Broker(ref).execute(sql).rows
    finally:
        broker.shutdown()


def test_lookup_udf_in_selection_and_groupby(clusters):
    broker = Broker(clusters[0])
    try:
        res = broker.execute(QUERIES[0])
        by_cust = {r[0]: r[1] for r in res.rows}
        assert by_cust[1] == "US" and by_cust[2] == "FR" and by_cust[9] == "null"  # miss -> null
        assert broker.execute(QUERIES[1]).rows[0][0] == 100 + 200 + 300 + 100
    finally:
        broker.shutdown()


def test_lookup_launches_no_kernel(clusters):
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    broker = Broker(clusters[0])
    try:
        before = KERNELS.stats_snapshot()
        broker.execute("SELECT cust_id, LOOKUP('customers', 'nation', 'cust_id', cust_id) FROM orders LIMIT 3")
        assert KERNELS.stats_snapshot() == before
    finally:
        broker.shutdown()


@pytest.mark.parametrize(
    "sql,match",
    [
        ("SELECT LOOKUP('nope', 'x', 'cust_id', cust_id) FROM orders LIMIT 1", "no dimension table"),
        ("SELECT LOOKUP('customers', 'nation', 'amount', amount) FROM orders LIMIT 1", "must match dim table PK"),
    ],
)
def test_lookup_errors_equal_reference(clusters, sql, match):
    port, ref = clusters
    broker = Broker(port)
    try:
        with pytest.raises(Exception, match=match):
            broker.execute(sql)
        with pytest.raises(Exception, match=match):
            rc.Broker(ref).execute(sql)
    finally:
        broker.shutdown()


def test_delete_table_unregisters(clusters):
    port, _ = clusters
    port.delete_table("customers")
    with pytest.raises(KeyError, match="no dimension table"):
        get_dim_table("customers")


class _CI:
    def __init__(self, vals):
        self._v = np.asarray(vals)

    def materialize(self):
        return self._v


class _FakeSeg:
    def __init__(self, columns):
        self.columns = {c: _CI(v) for c, v in columns.items()}
        self.n_docs = len(next(iter(columns.values())))


@pytest.mark.parametrize(
    "columns,dest,keys",
    [
        ({"k": ["a", "b"], "v": [1.5, 2.5]}, "v", [("a",), ("zz",), ("b",)]),
        ({"k": ["a", "b"], "name": ["x", "y"]}, "name", [("zz",), ("zw",)]),
    ],
    ids=["numeric_miss_nan", "all_miss_string_stays_string"],
)
def test_dim_manager_direct_equals_reference(columns, dest, keys):
    m = DimensionTableDataManager("d", ["k"])
    r = rdim.DimensionTableDataManager("d", ["k"])
    m.load_segments([_FakeSeg(columns)])
    r.load_segments([_FakeSeg(columns)])
    got, want = m.lookup_column(dest, keys), r.lookup_column(dest, keys)
    assert got.dtype == want.dtype
    assert [str(x) for x in got] == [str(x) for x in want]


def test_lookup_column_schema_string_before_any_segment_load():
    schema = Schema.build(
        "d", dimensions=[("k", DataType.STRING), ("name", DataType.STRING)],
        metrics=[("v", DataType.DOUBLE)], primary_key_columns=["k"],
    )
    m = DimensionTableDataManager("d", ["k"], schema=schema)
    assert list(m.lookup_column("name", [("zz",)])) == ["null"]
    assert np.isnan(m.lookup_column("v", [("zz",)])[0])
    with pytest.raises(ValueError, match="primaryKeyColumns"):
        DimensionTableDataManager("d", [])
