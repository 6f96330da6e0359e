"""The whole iteration's share of the chip's roofline (%): the least time
of one step whatever implements it (X read once, whatever the redundancy
S; ``roofline.step_work``) over the run's measured time per iteration."""

from h100bench.harness import roofline


def read(rec):
    if rec.get("kind") != "powerit" or not rec["iterations"]:
        return None
    least_ms, _ = roofline.bound_ms(*roofline.step_work(rec["dim"]))
    return 100.0 * least_ms * rec["iterations"] / (1e3 * rec["window_s"])
