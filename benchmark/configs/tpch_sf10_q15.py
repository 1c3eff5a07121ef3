"""TPC-H lineitem and supplier at the configured scale factor: the same
generator as `tpch_lineitem_sf10`, so that at one seed both
configurations hold the same rows. The harness loads only the columns
that the JSON file lists."""

from benchmark.configs.tpch_lineitem_sf10 import generate

__all__ = ["generate"]
