"""Serving half of the DB-PIM sparsity layer: stacked joint-sparse tables."""
