"""Columnar storage: segments, columns, tables, buffer manager, checkpoint."""
