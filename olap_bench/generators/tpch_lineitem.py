"""TPC-H's lineitem, by dbgen's rules (TPC-H specification 3.0, clause 4.2.3):

- 1,500,000 x SF orders of 1-7 lines, o_orderdate uniform from 1992-01-01 to
  1998-12-31 less 151 days; the lines are cut to the configuration's count;
- l_partkey uniform over 200,000 x SF parts, l_suppkey one of the part's four
  suppliers, (partkey + i x (S / 4 + (partkey - 1) / S)) mod S + 1, S =
  10,000 x SF, i uniform 0-3;
- l_quantity 1-50, l_extendedprice = quantity x the part's retail price,
  l_discount 0.00-0.10, l_tax 0.00-0.08 (decimals in cents);
- l_shipdate = orderdate + 1-121 days, l_commitdate = orderdate + 30-90,
  l_receiptdate = shipdate + 1-30;
- l_returnflag "R" or "A" when the receipt date is on or before 1995-06-17,
  else "N"; l_linestatus "O" when the ship date is after 1995-06-17, else "F";
- l_shipinstruct and l_shipmode uniform over their 4 and 7 values;
- l_comment a text of 10-43 characters (clause 4.2.2.10): a substring, at an
  offset drawn uniformly, of a text pool of the configuration's
  `text_pool_bytes` (dbgen's 300 MB) made of sentences of the clause's
  words.

l_comment is drawn after every other column, so the other columns are the
same with or without it.
"""

from __future__ import annotations

import datetime as _dt

import torch

from olap_bench.table import (
    Column,
    Table,
    days,
    lookup_column,
    order_lines,
    raw_column,
    retail_cents,
    sparse_order_key,
    text_column,
    text_pool,
    uniform,
)

FIRST_DAY, LAST_ORDER_DAY, CURRENT_DAY = "1992-01-01", "1998-08-02", "1995-06-17"
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
SHIPMODE = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
# the word lists of TPC-H's text grammar (clause 4.2.2.10)
NOUNS = (
    "foxes ideas theodolites pinto_beans instructions dependencies excuses platelets asymptotes courts dolphins "
    "multipliers sauternes warthogs frets dinos attainments somas Tiresias patterns forges braids hockey_players "
    "frays warhorses dugouts notornis epitaphs pearls tithes waters orbits gifts sheaves depths sentiments decoys "
    "realms pains grouches escapades packages requests accounts deposits"
)
VERBS = (
    "sleep wake are cajole haggle nag use boost affix detect integrate maintain nod was lose sublate solve thrash "
    "promise engage hinder print x-ray breach eat grow impress mold poach serve run dazzle snooze doze unwind kindle "
    "play hang believe doubt"
)
ADJECTIVES = (
    "furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged daring brave stealthy permanent "
    "enticing idle busy regular final ironic even bold silent express special pending unusual fancy"
)
ADVERBS = (
    "sometimes always never furiously slyly carefully blithely quickly fluffily slowly quietly ruthlessly thinly "
    "closely doggedly daringly bravely stealthily permanently enticingly idly busily regularly finally ironically "
    "evenly boldly silently"
)
PREPOSITIONS = (
    "about above according_to across after against along alongside_of among around at atop before behind beneath "
    "beside besides between beyond by despite during except for from in_place_of inside instead_of into near of on "
    "outside over past since through throughout to toward under until up upon without with within"
)
AUXILIARIES = (
    "do may might shall will would can could should ought_to must will_have_to shall_have_to could_have_to "
    "should_have_to must_have_to need_to try_to"
)
TERMINATORS = ". ; : ? ! --"


def _words(text: str) -> list[str]:
    return [w.replace("_", " ") for w in text.split()]


#: a sentence: noun phrase, verb phrase, prepositional phrase, terminator;
#: each slot filled with its chance (None: with the slot before)
SENTENCE = [
    (_words(ADVERBS), 0.25),
    (_words(ADJECTIVES), 0.5),
    (_words(NOUNS), 1.0),
    (_words(AUXILIARIES), 0.25),
    (_words(VERBS), 1.0),
    (_words(ADVERBS), 0.5),
    (_words(PREPOSITIONS), 0.5),
    (["the"], None),
    (_words(NOUNS), None),
    (_words(TERMINATORS), 1.0),
]


def generate(config: dict, seed: int, device: torch.device) -> Table:
    sf = config["scale_factor"]
    n_rows = config["rows"]
    n_orders = int(1_500_000 * sf)
    n_part, n_supp = int(200_000 * sf), int(10_000 * sf)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    order, number = order_lines(gen, n_orders, 7, n_rows)
    # every day a line's dates can take: the order dates, then up to 121 + 30
    # days past the last of them
    calendar = days(FIRST_DAY, (_dt.date.fromisoformat(LAST_ORDER_DAY) + _dt.timedelta(151)).isoformat())
    current = calendar.index(_dt.date.fromisoformat(CURRENT_DAY))
    n_order_days = calendar.index(_dt.date.fromisoformat(LAST_ORDER_DAY)) + 1
    ordered = uniform(gen, 0, n_order_days - 1, n_orders)[order]
    ship = ordered + uniform(gen, 1, 121, n_rows)
    commit = ordered + uniform(gen, 30, 90, n_rows)
    receipt = ship + uniform(gen, 1, 30, n_rows)
    part = uniform(gen, 1, n_part, n_rows)
    supp = (part + uniform(gen, 0, 3, n_rows) * (n_supp // 4 + (part - 1) // n_supp)) % n_supp + 1
    quantity = uniform(gen, 1, 50, n_rows)
    # "R" / "A" drawn for every line, kept where the receipt is on or before
    # the current date
    returned = uniform(gen, 0, 1, n_rows)
    flag = torch.where(receipt <= current, returned, torch.full_like(returned, 2))
    iso = [d.isoformat() for d in calendar]

    cols: dict[str, Column] = {
        "l_orderkey": raw_column("INT", "dimension", sparse_order_key(order)),
        "l_partkey": raw_column("INT", "dimension", part),
        "l_suppkey": raw_column("INT", "dimension", supp),
        "l_linenumber": raw_column("INT", "dimension", number),
        "l_quantity": raw_column("DOUBLE", "metric", quantity * 100, scale=2),
        "l_extendedprice": raw_column("DOUBLE", "metric", quantity * retail_cents(part), scale=2),
        "l_discount": raw_column("DOUBLE", "metric", uniform(gen, 0, 10, n_rows), scale=2),
        "l_tax": raw_column("DOUBLE", "metric", uniform(gen, 0, 8, n_rows), scale=2),
        "l_returnflag": lookup_column("STRING", "dimension", ["R", "A", "N"], flag),
        "l_linestatus": lookup_column("STRING", "dimension", ["F", "O"], (ship > current).long()),
        "l_shipdate": lookup_column("STRING", "date_time", iso, ship),
        "l_commitdate": lookup_column("STRING", "dimension", iso, commit),
        "l_receiptdate": lookup_column("STRING", "dimension", iso, receipt),
        "l_shipinstruct": lookup_column("STRING", "dimension", SHIPINSTRUCT, uniform(gen, 0, 3, n_rows)),
        "l_shipmode": lookup_column("STRING", "dimension", SHIPMODE, uniform(gen, 0, 6, n_rows)),
    }
    cols["l_comment"] = text_column(gen, text_pool(gen, config["text_pool_bytes"], SENTENCE), 10, 43, n_rows)
    return Table("lineitem", cols)
