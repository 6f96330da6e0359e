"""95th percentile (nearest rank) of every query's latency from its due
time (ms); a query never answered counts as infinitely late, so where more
than one in twenty is, nothing is read."""

import math

import numpy as np


def read(rec):
    if rec.get("kind") != "serve" or not rec["queries"]:
        return None
    lat = np.sort(np.where(np.isnan(rec["latency_s"]), np.inf,
                           rec["latency_s"]))
    v = float(lat[math.ceil(0.95 * len(lat)) - 1])
    return 1e3 * v if math.isfinite(v) else None
