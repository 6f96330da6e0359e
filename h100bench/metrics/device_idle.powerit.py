"""Share of the traced slice in which no kernel, copy or memset ran on the
device (%), in the powerit cells."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "powerit" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
