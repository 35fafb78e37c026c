"""Auxiliary index structures: bloom, inverted, range, text, JSON, geo, vector.

Reference parity:
 * Bloom filter — BloomFilterSegmentPruner + bloom creators
   (pinot-core/.../query/pruner/BloomFilterSegmentPruner.java;
   segment-local bloom filter index). Used host-side to prune whole segments
   on EQ/IN predicates before any device work.
 * Inverted index — BitmapInvertedIndexReader (dictId -> RoaringBitmap of
   docIds, pinot-segment-spi/.../index/reader/InvertedIndexReader.java:24).
   The device program's dense-mask compare over dict ids already is the
   vectorized inverted probe, so the CSR posting-list form here serves the
   HOST paths — selective point lookups (selection queries with tiny result
   sets), doc-id enumeration without scanning, and upsert bookkeeping.
 * Range index — RangeIndexBasedFilterOperator's bucketed variant: per-column
   sorted doc order + bucket boundaries enabling host-side range -> doc-id
   slices.

This is the JAX package's `segment/indexes.py`: every structure builds and
probes in numpy on the host and persists in the segment file
(segment/store.py), so the two packages' files carry the same indexes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pinot_tpu_torch.common.scan_probe import record_index_probe
from pinot_tpu_torch.query.sketches import murmur_mix32


# ---------------------------------------------------------------------------
# Bloom filter
# ---------------------------------------------------------------------------


@dataclass
class BloomFilter:
    """Split-hash bloom filter over a column's distinct values."""

    bits: np.ndarray  # uint64 words
    n_hashes: int

    NBITS_PER_VALUE = 16  # ~0.04% fpp at k=4

    @staticmethod
    def build(values: np.ndarray, n_hashes: int = 4) -> "BloomFilter":
        from pinot_tpu_torch.query.sketches import hash_any

        n = max(len(values), 1)
        m = 1 << max(8, int(np.ceil(np.log2(n * BloomFilter.NBITS_PER_VALUE))))
        words = np.zeros(m // 64, dtype=np.uint64)
        h1 = hash_any(values).astype(np.uint64)
        h2 = murmur_mix32((h1 ^ np.uint64(0x9E3779B9)).astype(np.uint32)).astype(np.uint64)
        for k in range(n_hashes):
            idx = (h1 + np.uint64(k) * h2) % np.uint64(m)
            np.bitwise_or.at(words, (idx // 64).astype(np.int64), np.uint64(1) << (idx % np.uint64(64)))
        return BloomFilter(words, n_hashes)

    def might_contain(self, value) -> bool:
        from pinot_tpu_torch.query.sketches import hash_any

        record_index_probe("bloom", self.n_hashes)
        m = np.uint64(len(self.bits) * 64)
        h1 = hash_any(np.asarray([value]))[0].astype(np.uint64)
        h2 = murmur_mix32(np.asarray([h1 ^ np.uint64(0x9E3779B9)], dtype=np.uint32))[0].astype(np.uint64)
        for k in range(self.n_hashes):
            idx = (h1 + np.uint64(k) * h2) % m
            if not (self.bits[int(idx // np.uint64(64))] >> (idx % np.uint64(64))) & np.uint64(1):
                return False
        return True


# ---------------------------------------------------------------------------
# Inverted index (CSR posting lists over dict ids)
# ---------------------------------------------------------------------------


@dataclass
class InvertedIndex:
    """dictId -> sorted docId posting lists in CSR layout."""

    offsets: np.ndarray  # (cardinality+1,) int64
    doc_ids: np.ndarray  # (n_docs,) int32, grouped by dict id

    @staticmethod
    def build(dict_ids: np.ndarray, cardinality: int) -> "InvertedIndex":
        order = np.argsort(dict_ids, kind="stable")
        counts = np.bincount(dict_ids, minlength=cardinality)
        offsets = np.zeros(cardinality + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return InvertedIndex(offsets, order.astype(np.int32))

    def postings(self, dict_id: int) -> np.ndarray:
        out = np.sort(self.doc_ids[self.offsets[dict_id] : self.offsets[dict_id + 1]])
        record_index_probe("inverted", len(out))
        return out

    def postings_for_many(self, ids: np.ndarray) -> np.ndarray:
        if len(ids) == 0:
            return np.empty(0, dtype=np.int32)
        out = np.sort(np.concatenate([self.doc_ids[self.offsets[i] : self.offsets[i + 1]] for i in ids]))
        record_index_probe("inverted", len(out))
        return out


# ---------------------------------------------------------------------------
# Range index (value-sorted doc order; range -> doc slice)
# ---------------------------------------------------------------------------


@dataclass
class RangeIndex:
    """Doc ids sorted by column value + the sorted values, so any value range
    maps to one contiguous doc-id slice via two binary searches."""

    sorted_doc_ids: np.ndarray  # (n_docs,) int32
    sorted_values: np.ndarray  # (n_docs,) column dtype (or dict ids)

    @staticmethod
    def build(values: np.ndarray) -> "RangeIndex":
        order = np.argsort(values, kind="stable")
        return RangeIndex(order.astype(np.int32), np.asarray(values)[order])

    def docs_in_range(self, lo, hi, lo_incl: bool = True, hi_incl: bool = True) -> np.ndarray:
        a = np.searchsorted(self.sorted_values, lo, side="left" if lo_incl else "right")
        b = np.searchsorted(self.sorted_values, hi, side="right" if hi_incl else "left")
        record_index_probe("range", max(0, int(b) - int(a)))
        return np.sort(self.sorted_doc_ids[a:b])


# ---------------------------------------------------------------------------
# Text index (tokenized inverted index)
# ---------------------------------------------------------------------------


_TOKEN_RX = None


def _tokenize_text(s: str) -> list[str]:
    global _TOKEN_RX
    if _TOKEN_RX is None:
        import re

        _TOKEN_RX = re.compile(r"[a-z0-9]+")
    return _TOKEN_RX.findall(s.lower())


@dataclass
class TextIndex:
    """Token -> doc-id posting lists (CSR over a sorted token vocabulary).

    Reference parity: Pinot's Lucene text index probed by TEXT_MATCH
    (TextMatchFilterOperator); the native-FST variant is the pure-Java FSA in
    segment-local utils/nativefst. Redesigned: the probe produces a dense doc
    mask host-side, which ANDs into the device filter as an operand — the same
    bitmap-into-filter contract Pinot uses.

    Query grammar (Lucene-lite): whitespace-separated terms OR by default,
    explicit AND/OR (left-assoc, AND binds tighter), `term*` prefix wildcard,
    `"quoted phrase"` = AND of its terms (positions are not indexed).
    """

    vocab: np.ndarray  # sorted token vocabulary (coerced to str dtype once)
    offsets: np.ndarray  # (V+1,) int64
    doc_ids: np.ndarray  # int32 postings, grouped by token
    n_docs: int

    def __post_init__(self):
        # one-time str coercion so per-term probes stay O(log V)
        self.vocab = np.asarray(self.vocab).astype(str)

    @staticmethod
    def build(values: np.ndarray) -> "TextIndex":
        pairs_tok: list[str] = []
        pairs_doc: list[int] = []
        for doc, s in enumerate(values):
            for t in set(_tokenize_text(str(s))):
                pairs_tok.append(t)
                pairs_doc.append(doc)
        if not pairs_tok:
            return TextIndex(np.empty(0, dtype=object), np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int32), len(values))
        toks = np.asarray(pairs_tok, dtype=object)
        docs = np.asarray(pairs_doc, dtype=np.int32)
        vocab, tok_ids = np.unique(toks.astype(str), return_inverse=True)
        order = np.lexsort((docs, tok_ids))
        counts = np.bincount(tok_ids, minlength=len(vocab))
        offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return TextIndex(vocab.astype(object), offsets, docs[order], len(values))

    def _term_docs(self, term: str) -> np.ndarray:
        term = term.lower()
        v = self.vocab
        if term.endswith("*"):
            pre = term[:-1]
            a = np.searchsorted(v, pre)
            b = np.searchsorted(v, pre + "￿")
            if a == b:
                return np.empty(0, dtype=np.int32)
            return np.unique(np.concatenate([self.doc_ids[self.offsets[i] : self.offsets[i + 1]] for i in range(a, b)]))
        i = np.searchsorted(v, term)
        if i >= len(v) or v[i] != term:
            return np.empty(0, dtype=np.int32)
        return self.doc_ids[self.offsets[i] : self.offsets[i + 1]]

    def _atom_mask(self, p: str) -> np.ndarray:
        if p.startswith('"') and p.endswith('"'):
            terms = _tokenize_text(p[1:-1])
            if not terms:
                return np.zeros(self.n_docs, dtype=bool)  # Lucene: empty phrase matches nothing
            m = np.ones(self.n_docs, dtype=bool)
            for t in terms:
                tm = np.zeros(self.n_docs, dtype=bool)
                tm[self._term_docs(t)] = True
                m &= tm
            return m
        m = np.zeros(self.n_docs, dtype=bool)
        m[self._term_docs(p)] = True
        return m

    def search(self, query: str) -> np.ndarray:
        """Evaluate a TEXT_MATCH query -> bool doc mask. AND binds tighter
        than OR; adjacent terms without an operator join with OR (Lucene
        default-operator behavior)."""
        import re as _re

        parts = _re.findall(r'"[^"]*"|\S+', query)
        # fold into OR groups of AND chains: a OR b AND c == a OR (b AND c)
        or_groups: list[np.ndarray] = []
        current: np.ndarray | None = None
        pending_and = False
        for p in parts:
            up = p.upper()
            if up == "AND":
                pending_and = True
                continue
            if up == "OR":
                continue  # OR is the default joiner between groups
            m = self._atom_mask(p)
            if current is None:
                current = m
            elif pending_and:
                current = current & m
            else:
                or_groups.append(current)
                current = m
            pending_and = False
        if current is not None:
            or_groups.append(current)
        if not or_groups:
            return np.zeros(self.n_docs, dtype=bool)
        out = or_groups[0]
        for g in or_groups[1:]:
            out = out | g
        record_index_probe("text", int(out.sum()))
        return out


# ---------------------------------------------------------------------------
# JSON index (flattened path=value posting lists)
# ---------------------------------------------------------------------------


def _flatten_json(obj, path: str, out: set):
    if isinstance(obj, dict):
        out.add(path if path else "$")
        for k, v in obj.items():
            _flatten_json(v, f"{path}.{k}" if path else f"$.{k}", out)
    elif isinstance(obj, list):
        for v in obj:
            _flatten_json(v, f"{path}[*]", out)
    else:
        out.add(path)  # existence key
        if isinstance(obj, bool):
            sv = "true" if obj else "false"
        elif obj is None:
            sv = "null"
        elif isinstance(obj, float) and obj.is_integer():
            sv = str(int(obj))
        else:
            sv = str(obj)
        out.add(f"{path}={sv}")


@dataclass
class JsonIndex:
    """Flattened JSON path / path=value keys -> doc posting lists.

    Reference parity: Pinot's json_index probed by JSON_MATCH
    (JsonMatchFilterOperator; segment-local json index). Arrays flatten with
    `[*]` wildcards. Supported JSON_MATCH grammar: `"$.path"='value'`,
    `"$.path" <> 'value'`, `"$.path" IS NOT NULL`, `"$.path" IS NULL`,
    combined with AND / OR.
    """

    keys: np.ndarray  # flattened keys, sorted (coerced to str dtype once)
    offsets: np.ndarray  # (K+1,) int64
    doc_ids: np.ndarray  # int32 postings
    n_docs: int

    def __post_init__(self):
        self.keys = np.asarray(self.keys).astype(str)

    @staticmethod
    def build(values: np.ndarray) -> "JsonIndex":
        import json as _json

        pairs_key: list[str] = []
        pairs_doc: list[int] = []
        for doc, s in enumerate(values):
            try:
                obj = _json.loads(s) if isinstance(s, (str, bytes)) else s
            except (ValueError, TypeError):
                continue
            flat: set = set()
            _flatten_json(obj, "", flat)
            for k in flat:
                pairs_key.append(k)
                pairs_doc.append(doc)
        if not pairs_key:
            return JsonIndex(np.empty(0, dtype=object), np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int32), len(values))
        keys = np.asarray(pairs_key, dtype=object)
        docs = np.asarray(pairs_doc, dtype=np.int32)
        vocab, key_ids = np.unique(keys.astype(str), return_inverse=True)
        order = np.lexsort((docs, key_ids))
        counts = np.bincount(key_ids, minlength=len(vocab))
        offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return JsonIndex(vocab.astype(object), offsets, docs[order], len(values))

    def _key_docs(self, key: str) -> np.ndarray:
        v = self.keys
        i = np.searchsorted(v, key)
        if i >= len(v) or v[i] != key:
            return np.empty(0, dtype=np.int32)
        return self.doc_ids[self.offsets[i] : self.offsets[i + 1]]

    def match(self, filter_str: str) -> np.ndarray:
        """Evaluate a JSON_MATCH filter string -> bool doc mask."""
        import re as _re

        # precedence: OR < AND < atom
        tokens = _re.findall(
            r"""'(?:[^']|'')*'|"(?:[^"]|"")*"|<>|!=|=|\(|\)|IS\s+NOT\s+NULL|IS\s+NULL|AND\b|OR\b""",
            filter_str,
            _re.IGNORECASE,
        )
        pos = 0

        def peek():
            return tokens[pos] if pos < len(tokens) else None

        def parse_or():
            nonlocal pos
            m = parse_and()
            while peek() is not None and peek().upper() == "OR":
                pos += 1
                m = m | parse_and()
            return m

        def parse_and():
            nonlocal pos
            m = parse_atom()
            while peek() is not None and peek().upper() == "AND":
                pos += 1
                m = m & parse_atom()
            return m

        def parse_atom():
            nonlocal pos
            t = peek()
            if t == "(":
                pos += 1
                m = parse_or()
                if peek() != ")":
                    raise ValueError(f"JSON_MATCH: missing ')' in {filter_str!r}")
                pos += 1
                return m
            if t is None or not (t.startswith('"') or t.startswith("'")):
                raise ValueError(f"JSON_MATCH: expected path at {t!r} in {filter_str!r}")
            path = t[1:-1].replace('""', '"') if t.startswith('"') else t[1:-1].replace("''", "'")
            pos += 1
            op = peek()
            if op is None:
                raise ValueError(f"JSON_MATCH: dangling path in {filter_str!r}")
            up = _re.sub(r"\s+", " ", op.upper())
            if up == "IS NOT NULL":
                pos += 1
                m = np.zeros(self.n_docs, dtype=bool)
                m[self._key_docs(path)] = True
                return m
            if up == "IS NULL":
                pos += 1
                m = np.ones(self.n_docs, dtype=bool)
                m[self._key_docs(path)] = False
                return m
            if op in ("=", "<>", "!="):
                pos += 1
                vt = peek()
                if vt is None:
                    raise ValueError(f"JSON_MATCH: missing value in {filter_str!r}")
                pos += 1
                value = vt[1:-1].replace("''", "'") if vt.startswith("'") else vt
                m = np.zeros(self.n_docs, dtype=bool)
                m[self._key_docs(f"{path}={value}")] = True
                return m if op == "=" else ~m
            raise ValueError(f"JSON_MATCH: unsupported operator {op!r}")

        out = parse_or()
        if pos != len(tokens):
            raise ValueError(f"JSON_MATCH: trailing tokens in {filter_str!r}")
        record_index_probe("json", int(out.sum()))
        return out


# ---------------------------------------------------------------------------
# Geo grid index (H3-analog: equirectangular cells over a lat/lng column pair)
# ---------------------------------------------------------------------------

_EARTH_R_M = 6371008.8


@dataclass
class GeoGridIndex:
    """Quantized lat/lng grid cells -> doc posting lists + bounding box.

    Reference parity: Pinot's H3 index (H3IndexFilterOperator) pruning
    ST_DISTANCE(col, point) < r probes. The distance compare itself runs in
    the device program as a vectorized haversine over the raw
    lat/lng columns (transforms.st_distance); this index serves the HOST roles
    — whole-segment pruning via the bbox and selective candidate enumeration
    via cell postings.
    """

    lat_col: str
    lng_col: str
    res_deg: float
    cells: np.ndarray  # int64 sorted distinct cell ids
    offsets: np.ndarray  # (C+1,) int64
    doc_ids: np.ndarray  # int32
    bbox: tuple  # (min_lat, max_lat, min_lng, max_lng)

    @staticmethod
    def cell_of(lat: np.ndarray, lng: np.ndarray, res_deg: float) -> np.ndarray:
        ncols = int(np.ceil(360.0 / res_deg))
        r = (np.floor((np.asarray(lat) + 90.0) / res_deg)).astype(np.int64)
        c = (np.floor((np.asarray(lng) + 180.0) / res_deg)).astype(np.int64)
        return r * ncols + c

    @staticmethod
    def build(lat_col: str, lng_col: str, lat: np.ndarray, lng: np.ndarray, res_deg: float = 0.5) -> "GeoGridIndex":
        cell = GeoGridIndex.cell_of(lat, lng, res_deg)
        cells, ids = np.unique(cell, return_inverse=True)
        order = np.lexsort((np.arange(len(cell)), ids))
        counts = np.bincount(ids, minlength=len(cells))
        offsets = np.zeros(len(cells) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        bbox = (float(np.min(lat)), float(np.max(lat)), float(np.min(lng)), float(np.max(lng))) if len(lat) else (0.0, 0.0, 0.0, 0.0)
        return GeoGridIndex(lat_col, lng_col, res_deg, cells, offsets, order.astype(np.int32), bbox)

    def min_distance_m(self, qlat: float, qlng: float) -> float:
        return bbox_min_distance_m(self.bbox, qlat, qlng)

    def candidate_docs(self, qlat: float, qlng: float, radius_m: float) -> np.ndarray:
        """Doc ids in cells intersecting the circle's bounding box."""
        dlat = np.degrees(radius_m / _EARTH_R_M)
        dlng = dlat / max(np.cos(np.radians(qlat)), 1e-6)
        lats = np.arange(qlat - dlat, qlat + dlat + self.res_deg, self.res_deg)
        lngs = np.arange(qlng - dlng, qlng + dlng + self.res_deg, self.res_deg)
        grid_lat, grid_lng = np.meshgrid(lats, lngs)
        wanted = np.unique(GeoGridIndex.cell_of(grid_lat.ravel(), grid_lng.ravel(), self.res_deg))
        idx = np.searchsorted(self.cells, wanted)
        hits = [i for w, i in zip(wanted, idx) if i < len(self.cells) and self.cells[i] == w]
        if not hits:
            record_index_probe("geo", 0)
            return np.empty(0, dtype=np.int32)
        out = np.concatenate([self.doc_ids[self.offsets[i] : self.offsets[i + 1]] for i in hits])
        record_index_probe("geo", len(out))
        return out


def bbox_min_distance_m(bbox: tuple, qlat: float, qlng: float) -> float:
    """Lower bound on distance from a query point to any doc in the bbox:
    clamp the point into the box; longitude clamping runs at qlng and
    qlng±360 so the bound stays valid across the antimeridian. Shared by
    the hex (H3Index) and legacy grid geo indexes — the pruner depends on
    both behaving identically."""
    min_lat, max_lat, min_lng, max_lng = bbox
    clat = min(max(qlat, min_lat), max_lat)
    best = np.inf
    for q in (qlng, qlng + 360.0, qlng - 360.0):
        clng = min(max(q, min_lng), max_lng)
        best = min(best, float(haversine_m(qlat, q, clat, clng)))
    return best


def haversine(xp, lat1, lng1, lat2, lng2):
    """Great-circle distance in meters, generic over the array module, so
    the host pruner and the host filter share ONE formula and earth radius."""
    p1, p2 = xp.radians(lat1), xp.radians(lat2)
    dp = p2 - p1
    dl = xp.radians(lng2) - xp.radians(lng1)
    a = xp.sin(dp / 2) ** 2 + xp.cos(p1) * xp.cos(p2) * xp.sin(dl / 2) ** 2
    return 2 * _EARTH_R_M * xp.arcsin(xp.sqrt(a))


def haversine_m(lat1, lng1, lat2, lng2):
    """Great-circle distance in meters (scalar or numpy)."""
    return haversine(np, np.asarray(lat1, dtype=np.float64), np.asarray(lng1, dtype=np.float64),
                     np.asarray(lat2, dtype=np.float64), np.asarray(lng2, dtype=np.float64))


# ---------------------------------------------------------------------------
# Vector index (normalized embedding matrix for brute-force top-k)
# ---------------------------------------------------------------------------


@dataclass
class VectorIndex:
    """Row-normalized (n_docs, dim) float32 embedding matrix.

    Reference parity: Pinot's HNSW vector index (Lucene) probed by
    VECTOR_SIMILARITY(col, literal, topK). Exact brute-force cosine top-k:
    one (n_docs, dim) x (dim,) product and a top-k per probe, no index build
    cost beyond normalization, and exact (recall 1.0) where HNSW is
    approximate.
    """

    vectors: np.ndarray  # (n_docs, dim) float32, L2-normalized rows

    @staticmethod
    def build(vectors: np.ndarray) -> "VectorIndex":
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        norms = np.linalg.norm(v, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        return VectorIndex(v / norms)

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def top_k(self, query: np.ndarray, k: int) -> np.ndarray:
        """Doc ids of the k nearest (cosine) docs."""
        q = np.asarray(query, dtype=np.float32).ravel()
        qn = np.linalg.norm(q)
        if qn > 0:
            q = q / qn
        scores = self.vectors @ q
        record_index_probe("vector", len(scores))
        k = min(k, len(scores))
        if k == 0:
            return np.empty(0, dtype=np.int32)
        idx = np.argpartition(-scores, k - 1)[:k]
        return idx[np.argsort(-scores[idx])].astype(np.int32)


# ---------------------------------------------------------------------------
# HNSW vector index (approximate nearest neighbor)
# ---------------------------------------------------------------------------


@dataclass
class HnswIndex:
    """Hierarchical Navigable Small World graph over L2-normalized vectors.

    Reference parity: Pinot's HNSW vector index (Lucene HNSW behind
    VectorSimilarityFilterOperator, StandardIndexes.java vector entry).
    The exact top-k (VectorIndex) is the default; HNSW is the option for
    probes over large corpora (IndexingConfig.vector_index_type = "HNSW").

    Standard construction (Malkov & Yashunin 2016): level ~ floor(-ln(U)*mL),
    greedy descent from the top layer, M neighbors per node with simple
    best-M pruning, efConstruction-bounded candidate beams.
    """

    vectors: np.ndarray  # (n, dim) float32, L2-normalized
    levels: np.ndarray  # (n,) int32 max layer per node
    # neighbors[layer][node] -> np.ndarray of neighbor ids
    graphs: list[dict]
    entry: int

    M = 16
    EF_CONSTRUCTION = 100
    EF_SEARCH = 64

    @staticmethod
    def build(vectors: np.ndarray, seed: int = 7) -> "HnswIndex":
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        norms = np.linalg.norm(v, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        v = v / norms
        n = len(v)
        rng = np.random.default_rng(seed)
        ml = 1.0 / np.log(max(HnswIndex.M, 2))
        levels = np.minimum(
            np.floor(-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int32), 8
        )
        max_level = int(levels.max()) if n else 0
        graphs: list[dict] = [dict() for _ in range(max_level + 1)]
        idx = HnswIndex(v, levels, graphs, entry=0)
        order = rng.permutation(n)
        first = True
        for node in order:
            idx._insert(int(node), first)
            first = False
        return idx

    def _sim(self, a: int, cand) -> np.ndarray:
        return self.vectors[cand] @ self.vectors[a]

    def _search_layer(self, q: np.ndarray, entry: int, layer: int, ef: int) -> list[int]:
        """Beam search one layer (Algorithm 2); returns ids best-first."""
        import heapq

        g = self.graphs[layer]
        visited = {entry}
        d0 = float(self.vectors[entry] @ q)
        results: list = [(d0, entry)]  # min-heap: worst retained on top
        frontier: list = [(-d0, entry)]  # max-heap by similarity
        while frontier:
            neg, node = heapq.heappop(frontier)
            if -neg < results[0][0] and len(results) >= ef:
                break  # closest unexplored is worse than the worst retained
            for nb in g.get(node, ()):
                nb = int(nb)
                if nb in visited:
                    continue
                visited.add(nb)
                d = float(self.vectors[nb] @ q)
                if len(results) < ef or d > results[0][0]:
                    heapq.heappush(frontier, (-d, nb))
                    heapq.heappush(results, (d, nb))
                    if len(results) > ef:
                        heapq.heappop(results)
        return [node for _, node in sorted(results, reverse=True)]

    def _insert(self, node: int, first: bool) -> None:
        if first:
            self.entry = node
            for layer in range(int(self.levels[node]) + 1):
                self.graphs[layer][node] = np.empty(0, dtype=np.int32)
            return
        q = self.vectors[node]
        lvl = int(self.levels[node])
        ep = self.entry
        top = int(self.levels[self.entry])
        for layer in range(top, lvl, -1):
            cands = self._search_layer(q, ep, layer, 1)
            ep = cands[0]
        for layer in range(min(lvl, top), -1, -1):
            cands = self._search_layer(q, ep, layer, self.EF_CONSTRUCTION)
            sims = self._sim(node, cands)
            keep = [c for _, c in sorted(zip(-sims, cands))[: self.M] if c != node]
            g = self.graphs[layer]
            g[node] = np.asarray(keep, dtype=np.int32)
            for nb in keep:
                cur = g.get(nb)
                cur = np.append(cur, node) if cur is not None else np.asarray([node], dtype=np.int32)
                if len(cur) > self.M * 2:  # prune to best M
                    s = self.vectors[cur] @ self.vectors[nb]
                    cur = cur[np.argsort(-s)[: self.M]]
                cur = cur.astype(np.int32)
                g[nb] = cur
            ep = cands[0]
        if lvl > top:
            self.entry = node
            for layer in range(top + 1, lvl + 1):
                self.graphs[layer].setdefault(node, np.empty(0, dtype=np.int32))

    def top_k(self, query: np.ndarray, k: int) -> np.ndarray:
        if len(self.vectors) == 0:
            return np.empty(0, dtype=np.int32)
        q = np.asarray(query, dtype=np.float32).ravel()
        qn = np.linalg.norm(q)
        if qn > 0:
            q = q / qn
        ep = self.entry
        for layer in range(len(self.graphs) - 1, 0, -1):
            ep = self._search_layer(q, ep, layer, 1)[0]
        cands = self._search_layer(q, ep, 0, max(self.EF_SEARCH, k))
        record_index_probe("vector", len(cands))
        cands = np.asarray(cands[: max(k * 4, k)], dtype=np.int64)
        sims = self.vectors[cands] @ q
        order = np.argsort(-sims)[:k]
        return cands[order].astype(np.int32)

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


# ---------------------------------------------------------------------------
# FST index (fast LIKE / REGEXP over dictionary values)
# ---------------------------------------------------------------------------


@dataclass
class FstIndex:
    """Prefix/regex acceleration over a SORTED string dictionary.

    Reference parity: Pinot's native FST index
    (pinot-segment-local/.../utils/nativefst/, StandardIndexes fst entry),
    which runs pattern automata over an FSA of the dictionary. Redesigned:
    a sorted dictionary already IS a prefix automaton — prefix patterns
    (LIKE 'abc%') resolve to ONE dict-id interval via two binary searches
    (O(log cardinality) vs the FSA walk), and non-prefix regexes fall back
    to a memoized scan whose result (a dict-id LUT) is cached per pattern,
    so repeated REGEXP_LIKE queries cost O(1) after the first.
    """

    values: np.ndarray  # sorted dictionary values (object array of str)

    def __post_init__(self):
        self._cache: dict[str, np.ndarray] = {}
        # fixed-width str copy built ONCE: prefix probes are then truly two
        # binary searches, not two O(cardinality) conversions per call
        self._sorted_str = self.values.astype(str)

    @staticmethod
    def build(sorted_values: np.ndarray) -> "FstIndex":
        return FstIndex(np.asarray(sorted_values, dtype=object))

    @staticmethod
    def _next_prefix(prefix: str) -> str | None:
        """Smallest string greater than every string starting with prefix
        (None = unbounded). Increments the last incrementable code point, so
        astral-plane characters sort correctly (no U+FFFF sentinel)."""
        p = prefix
        while p and ord(p[-1]) >= 0x10FFFF:
            p = p[:-1]
        if not p:
            return None
        return p[:-1] + chr(ord(p[-1]) + 1)

    def prefix_id_range(self, prefix: str) -> tuple[int, int]:
        """[lo, hi) dict-id interval of values starting with prefix."""
        lo = int(np.searchsorted(self._sorted_str, prefix, side="left"))
        nxt = self._next_prefix(prefix)
        hi = (
            len(self._sorted_str)
            if nxt is None
            else int(np.searchsorted(self._sorted_str, nxt, side="left"))
        )
        return lo, hi

    def matching_ids(self, pattern: str, full: bool) -> np.ndarray:
        """Bool LUT over dict ids for a regex; memoized per pattern."""
        key = ("F:" if full else "S:") + pattern
        hit = self._cache.get(key)
        if hit is not None:
            record_index_probe("fst", 0)  # memoized: no dictionary walk
            return hit
        import re as _re

        # prefix fast path: a literal prefix (plain or backslash-escaped
        # characters — LIKE 'user-00%' lowers to 'user\-00.*') followed by .*
        m = _re.fullmatch(r"((?:\\.|[^.\\^$*+?()\[\]{}|])+)\.\*", pattern)
        lut = None
        if full and m:
            lo, hi = self.prefix_id_range(_re.sub(r"\\(.)", r"\1", m.group(1)))
            lut = np.zeros(len(self.values), dtype=bool)
            lut[lo:hi] = True
        else:
            rx = _re.compile(pattern)
            match = rx.fullmatch if full else rx.search
            lut = np.fromiter(
                (bool(match(str(v))) for v in self.values), dtype=bool, count=len(self.values)
            )
        record_index_probe("fst", len(self.values))
        self._cache[key] = lut
        return lut


# ---------------------------------------------------------------------------
# Map index (key -> per-doc value columns for MAP-typed columns)
# ---------------------------------------------------------------------------


@dataclass
class MapIndex:
    """Per-key dense value columns for a column of JSON objects / maps.

    Reference parity: Pinot's map index (StandardIndexes map entry,
    MAP<STRING, V> columns): each distinct key materializes as a dense value
    vector so `map_value(col, 'key')` reads a plain column instead of
    parsing documents per row. Missing keys hold None.
    """

    keys: np.ndarray  # object array of key strings, sorted
    columns: dict  # key -> object ndarray (n_docs,)
    n_docs: int

    @staticmethod
    def build(values: np.ndarray) -> "MapIndex":
        import json as _json

        n = len(values)
        columns: dict = {}
        for i, v in enumerate(values):
            if isinstance(v, dict):
                doc = v
            else:
                try:
                    doc = _json.loads(v) if v else {}
                except (ValueError, TypeError):
                    doc = {}  # non-JSON rows contribute no keys
            if not isinstance(doc, dict):
                continue
            for k, val in doc.items():
                col = columns.get(k)
                if col is None:
                    col = columns[k] = np.full(n, None, dtype=object)
                col[i] = val
        return MapIndex(np.asarray(sorted(columns), dtype=object), columns, n)

    def value_column(self, key: str) -> np.ndarray:
        col = self.columns.get(key)
        if col is None:
            return np.full(self.n_docs, None, dtype=object)
        return col
