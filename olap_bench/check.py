"""What decides `correct`: every answer the window returned, held against
the plain reference's.

For each distinct query the window ran, each distinct set of rows the
program returned for it is compared with the reference's rows:

- `failed`: queries that raised or returned exceptions or a partial result;
- `rows_mismatched`: rows whose group key the other side lacks (a wrong row
  count shows here);
- `order_mismatched`: answers whose rows are not in the reference's ORDER BY
  order (rows tied on every ORDER BY key may come in any order);
- `max_rel_gap`: over every aggregate value of every matched row, the
  widest |program - reference| / |reference| (|program| where the reference
  is 0).

Each number has its limit; `correct` holds when none passes its limit.
"""

from __future__ import annotations

from olap_bench.reference.sql import parse


def _split(q) -> tuple[list[int], list[int]]:
    keys = [i for i, (n, _) in enumerate(q.select) if n.kind != "agg"]
    aggs = [i for i, (n, _) in enumerate(q.select) if n.kind == "agg"]
    return keys, aggs


def _order_keys(q, row: list) -> tuple:
    idx = []
    for node, _ in q.order_by:
        for i, (sel, name) in enumerate(q.select):
            if sel == node or (node.kind == "col" and name == node.value):
                idx.append(i)
                break
    return tuple(row[i] for i in idx)


def _gap(p, r) -> float:
    if p is None or r is None:
        return 0.0 if p is r else float("inf")
    p, r = float(p), float(r)
    if p == r:
        return 0.0
    return abs(p - r) / abs(r) if r != 0 else abs(p)


def compare(answers: dict, reference: dict, n_failed: int, limits: dict) -> tuple[dict, dict]:
    """(the numbers with their limits, details of the worst cases)."""
    rows_mismatched = order_mismatched = 0
    max_gap, worst = 0.0, None
    compared = 0
    for sql, seen in answers.items():
        q = parse(sql)
        key_idx, agg_idx = _split(q)
        ref_rows = reference[sql]
        ref_by_key = {tuple(r[i] for i in key_idx): r for r in ref_rows}
        ref_order = [_order_keys(q, r) for r in ref_rows]
        for rows in seen:
            compared += 1
            got_by_key = {tuple(r[i] for i in key_idx): r for r in rows}
            rows_mismatched += len(set(got_by_key) ^ set(ref_by_key)) + (len(rows) - len(got_by_key))
            for k, r in got_by_key.items():
                ref = ref_by_key.get(k)
                if ref is None:
                    continue
                for i in agg_idx:
                    g = _gap(r[i], ref[i])
                    if g > max_gap:
                        max_gap, worst = g, {"sql": sql, "key": list(k), "column": i, "got": r[i], "want": ref[i]}
            if q.order_by and set(got_by_key) == set(ref_by_key):
                # the reference's ORDER BY keys, read in the program's row order
                got_order = [_order_keys(q, ref_by_key[tuple(r[i] for i in key_idx)]) for r in rows]
                if got_order != ref_order:
                    order_mismatched += 1
    numbers = {
        "failed": {"value": n_failed, "limit": 0},
        "rows_mismatched": {"value": rows_mismatched, "limit": 0},
        "order_mismatched": {"value": order_mismatched, "limit": 0},
        "max_rel_gap": {"value": max_gap, "limit": limits["max_rel_gap"]},
    }
    return numbers, {"answers_compared": compared, "queries_compared": len(answers), "worst_gap": worst}


def passes(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
