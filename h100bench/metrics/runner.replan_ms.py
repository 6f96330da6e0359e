"""Mean host planning time of a window step, ``StepReport.replan_s`` (ms):
the runner's plan adoption (cache swap, or solve and compile on a miss)."""


def read(rec):
    if rec.get("kind") != "powerit" or not rec["steps"]:
        return None
    return 1e3 * sum(s[1] for s in rec["steps"]) / len(rec["steps"])
