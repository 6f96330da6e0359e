"""Device kernels (copies and memsets left out) in the traced slice per
iteration it completed."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "powerit" or not tr or not tr["iterations"]:
        return None
    return tr["n_kernels"] / tr["iterations"]
