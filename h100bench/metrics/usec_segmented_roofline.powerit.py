"""``usec_segmented``'s share of its roofline in the power-iteration cells
(%), one column (``roofline.segmented_share``)."""

from h100bench.harness import roofline


def read(rec):
    return roofline.segmented_share(rec, "powerit", "iterations", 1)
