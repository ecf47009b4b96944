"""Tests of the benchmark (``python -m pytest perfbench/tests -q``); card tests: ``cuda``."""
