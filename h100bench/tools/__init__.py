"""Measurement tools beside the benchmark: not run by ``run.py``."""
