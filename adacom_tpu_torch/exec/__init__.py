"""Execution: expression compilation, physical operators, pipelines."""
