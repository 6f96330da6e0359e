"""Mean over the window's steps of ``StepReport.modeled_completion`` (ms):
the iteration time the plan gives the modeled heterogeneous fleet, the
paper's objective."""


def read(rec):
    if rec.get("kind") != "powerit" or not rec["steps"]:
        return None
    return 1e3 * sum(s[2] for s in rec["steps"]) / len(rec["steps"])
