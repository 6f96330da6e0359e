"""Mean wall of an ``ElasticServer.poll`` that dispatched a window, timed
by the harness (ms)."""


def read(rec):
    if rec.get("kind") != "serve" or not rec["polls"]:
        return None
    return 1e3 * sum(w for w, _ in rec["polls"]) / len(rec["polls"])
