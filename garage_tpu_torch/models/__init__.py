"""Flagship compute pipelines (scrub + repair)."""
