"""Queries answered within the mix's latency limit, over the window (s)."""

import numpy as np


def read(rec):
    if rec.get("kind") != "serve":
        return None
    lat = rec["latency_s"]
    ok = np.sum(~np.isnan(lat) & (lat <= 1e-3 * rec["limit_ms"]))
    return float(ok) / rec["window_s"]
