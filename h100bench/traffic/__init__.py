"""Traffic generators (``<generator>.py``) and the mixes that drive them
(``<traffic>.json``, named by BENCHMARK.json's workloads)."""
