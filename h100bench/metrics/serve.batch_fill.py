"""Columns used over ``batch_cols`` per dispatched window, mean (%): each
answered matvec is one column."""


def read(rec):
    if rec.get("kind") != "serve" or not rec["polls"]:
        return None
    used = sum(n for _, n in rec["polls"])
    return 100.0 * used / (len(rec["polls"]) * rec["batch_cols"])
