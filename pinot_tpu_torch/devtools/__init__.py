"""Developer tooling that ships with the package but is not part of the
query path (analog of pinot-tools: code that polices the engine rather than
running queries)."""
