"""Wall time of the window over the iterations it completed (ms)."""


def read(rec):
    if rec.get("kind") != "powerit" or not rec["iterations"]:
        return None
    return 1e3 * rec["window_s"] / rec["iterations"]
