"""One general generator of query traffic, driven by a traffic file.

A traffic file (`olap_bench/traffic/<name>.json`) holds:

- `queries`: name -> SQL template; `{param}` marks a substitution;
- `params`: param -> rule, one of
  `{"date_minus_days": "1998-12-01", "days": [60, 120]}` (the ISO date that
  many days before the date, the count drawn uniformly, both ends included),
  `{"int": [lo, hi]}` (drawn uniformly, both ends included),
  `{"choice": [v, ...]}` (drawn uniformly);
- `clients`: how many client threads send queries, in a closed loop: a
  client sends its next query when its last returns, with no think time,
  walking its own seeded permutation of the queries over and over;
- `scheduler`: the program's query scheduler the server runs the queries
  on, as `{"kind": "fcfs", "runners": 4}` (`make_scheduler`'s kinds).

Every substitution is drawn afresh for each query sent. The order of queries
and their values come from the run's seed and the client's number.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import json
import re
import string
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_PARAM = re.compile(r"\{(\w+)\}")


def _domain(rule: dict) -> list:
    """Every value a rule can draw, in order."""
    if "date_minus_days" in rule:
        base = _dt.date.fromisoformat(rule["date_minus_days"])
        lo, hi = rule["days"]
        return [(base - _dt.timedelta(days=d)).isoformat() for d in range(lo, hi + 1)]
    if "int" in rule:
        lo, hi = rule["int"]
        return list(range(lo, hi + 1))
    if "choice" in rule:
        return list(rule["choice"])
    raise ValueError(f"unknown substitution rule {rule}")


@dataclass
class Traffic:
    name: str
    queries: dict[str, str]
    params: dict[str, list]
    clients: int
    scheduler: dict

    @staticmethod
    def load(path: Path) -> "Traffic":
        spec = json.loads(Path(path).read_text())
        params = {k: _domain(v) for k, v in spec.get("params", {}).items()}
        for name, sql in spec["queries"].items():
            missing = set(_PARAM.findall(sql)) - set(params)
            if missing:
                raise ValueError(f"{path}: query {name} uses undefined params {sorted(missing)}")
        return Traffic(
            Path(path).stem,
            dict(spec["queries"]),
            params,
            int(spec["clients"]),
            dict(spec["scheduler"]),
        )

    def _fill(self, template: str, values: dict) -> str:
        return string.Formatter().vformat(template, (), values) if values else template

    def distinct(self) -> list[tuple[str, str]]:
        """Every (query name, SQL) the traffic can send."""
        out = []
        for name, template in self.queries.items():
            used = sorted(set(_PARAM.findall(template)))
            for combo in itertools.product(*(self.params[p] for p in used)):
                out.append((name, self._fill(template, dict(zip(used, combo)))))
        return out

    def stream(self, seed: int, client: int):
        """The endless (query name, SQL) sequence client `client` sends."""
        rng = np.random.default_rng([seed % 2**64, client])
        names = list(self.queries)
        while True:
            for name in (names[i] for i in rng.permutation(len(names))):
                template = self.queries[name]
                values = {p: self.params[p][int(rng.integers(len(self.params[p])))] for p in sorted(set(_PARAM.findall(template)))}
                yield name, self._fill(template, values)
