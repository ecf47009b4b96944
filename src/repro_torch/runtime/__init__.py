"""Serving steps of the port (``repro.runtime`` minus its mesh and sharding code)."""
