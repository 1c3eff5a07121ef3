"""File formats of COPY and the read_* table functions: CSV, JSON, Parquet."""
