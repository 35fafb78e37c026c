"""Compatibility verifier: declarative op-replay suites for rolling-upgrade
testing.

Reference parity: pinot-compatibility-verifier/ (yaml op suites in
compatibility-verifier/sample-test-suite/): a suite written against version
N is replayed against version N+1 — table creation, data ingestion, queries
with expected results, segment ops — to prove the upgrade keeps wire/query
compatibility. Suites here are JSON files with an "operations" list:

    {"operations": [
       {"op": "createTable", "schema": {...Schema json...}, "config": {...}},
       {"op": "ingestRows", "table": "t", "rows": [{...}, ...]},
       {"op": "query", "sql": "...", "expectedRows": [[...]]},
       {"op": "deleteSegment", "table": "t", "segment": "..."},
       {"op": "reloadSegments", "table": "t"},
       {"op": "rebalance", "table": "t"}
    ]}

The cluster's server holds its segments on `device` and the broker runs its
multistage root stage there: "cuda" unless the caller passes "cpu" (with no
card and no `--device cpu` the first query raises).

Run: python -m pinot_tpu_torch.tools.compat_verifier --suite suite.json [--workdir D] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


class CompatFailure(AssertionError):
    pass


class CompatVerifier:
    """Replays one suite against a fresh in-process cluster."""

    def __init__(self, workdir: str | Path | None = None, device="cuda"):
        from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server

        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="pinot-tpu-torch-compat-")
            workdir = self._tmp.name
        self.workdir = Path(workdir)
        self.controller = Controller(PropertyStore(), self.workdir / "deepstore")
        self.server = Server("compat_server", device=device)
        self.controller.register_server("compat_server", self.server)
        self.broker = Broker(self.controller, device=device)
        self._ingest_seq: dict[str, int] = {}

    # -- operations ----------------------------------------------------------

    def op_createTable(self, spec: dict) -> None:
        from pinot_tpu_torch.common.config import TableConfig
        from pinot_tpu_torch.common.types import Schema

        schema = Schema.from_json(json.dumps(spec["schema"]))
        self.controller.add_schema(schema)
        cfg = spec.get("config") or {"tableName": schema.name}
        self.controller.add_table(TableConfig.from_json(json.dumps(cfg)))

    def op_ingestRows(self, spec: dict) -> None:
        import numpy as np

        from pinot_tpu_torch.segment.builder import SegmentBuilder

        table = spec["table"]
        schema = self.controller.get_schema(table)
        rows = spec["rows"]
        data = {}
        for col in schema.columns:
            vals = [r.get(col) for r in rows]
            arr = np.asarray(vals)
            data[col] = arr if arr.dtype != object else np.asarray(vals, dtype=object)
        seq = self._ingest_seq.get(table, 0)
        self._ingest_seq[table] = seq + 1
        seg = SegmentBuilder(schema, self.controller.get_table(table)).build(data, f"{table}_compat_{seq}")
        self.controller.upload_segment(table, seg)

    def op_query(self, spec: dict) -> None:
        res = self.broker.execute(spec["sql"])
        if "expectedRows" in spec:
            got = [list(r) for r in res.rows]
            want = [list(r) for r in spec["expectedRows"]]
            if spec.get("unordered"):
                got = sorted(got, key=repr)
                want = sorted(want, key=repr)
            if got != want:
                raise CompatFailure(f"query {spec['sql']!r}: rows {got} != expected {want}")
        if "expectedNumDocsScanned" in spec and res.num_docs_scanned != spec["expectedNumDocsScanned"]:
            raise CompatFailure(
                f"query {spec['sql']!r}: scanned {res.num_docs_scanned} != {spec['expectedNumDocsScanned']}"
            )

    def op_deleteSegment(self, spec: dict) -> None:
        self.controller.delete_segment(spec["table"], spec["segment"])

    def op_reloadSegments(self, spec: dict) -> None:
        self.controller.reload_segments(spec["table"], spec.get("segment"))

    def op_rebalance(self, spec: dict) -> None:
        from pinot_tpu_torch.cluster.rebalance import rebalance_table

        rebalance_table(self.controller, spec["table"])

    # -- driver --------------------------------------------------------------

    def run_suite(self, suite: dict) -> list[dict]:
        results = []
        for i, op_spec in enumerate(suite.get("operations", [])):
            op = op_spec.get("op")
            fn = getattr(self, f"op_{op}", None)
            if fn is None:
                raise CompatFailure(f"operation {i}: unknown op {op!r}")
            try:
                fn(op_spec)
                results.append({"index": i, "op": op, "status": "PASSED"})
            except CompatFailure:
                raise
            except Exception as e:
                raise CompatFailure(f"operation {i} ({op}) failed: {type(e).__name__}: {e}") from e
        return results

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()


SAMPLE_SUITE = {
    "description": "sample compat suite (compatibility-verifier/sample-test-suite analog)",
    "operations": [
        {
            "op": "createTable",
            "schema": {
                "schemaName": "compatEvents",
                "fields": [
                    {"name": "kind", "dataType": "STRING", "fieldType": "DIMENSION"},
                    {"name": "value", "dataType": "LONG", "fieldType": "METRIC"},
                ],
                "primaryKeyColumns": [],
            },
        },
        {
            "op": "ingestRows",
            "table": "compatEvents",
            "rows": [
                {"kind": "a", "value": 1},
                {"kind": "b", "value": 2},
                {"kind": "a", "value": 3},
            ],
        },
        {"op": "query", "sql": "SELECT COUNT(*) FROM compatEvents", "expectedRows": [[3]]},
        {
            "op": "query",
            "sql": "SELECT kind, SUM(value) FROM compatEvents GROUP BY kind ORDER BY kind",
            "expectedRows": [["a", 4.0], ["b", 2.0]],
        },
        {"op": "reloadSegments", "table": "compatEvents"},
        {"op": "query", "sql": "SELECT COUNT(*) FROM compatEvents", "expectedRows": [[3]]},
    ],
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="replay a compatibility suite")
    p.add_argument("--suite", help="suite JSON path (default: built-in sample)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda", help="where the cluster runs (default cuda; cpu without a card)")
    args = p.parse_args(argv)
    suite = json.loads(Path(args.suite).read_text()) if args.suite else SAMPLE_SUITE
    v = CompatVerifier(args.workdir, device=args.device)
    try:
        results = v.run_suite(suite)
    finally:
        v.close()
    print(json.dumps({"status": "PASSED", "operations": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
