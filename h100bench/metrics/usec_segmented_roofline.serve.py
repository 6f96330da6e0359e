"""``usec_segmented``'s share of its roofline in served windows (%), at the
lane's ``batch_cols`` columns (``roofline.segmented_share``)."""

from h100bench.harness import roofline


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return roofline.segmented_share(rec, "serve", "windows",
                                    rec["batch_cols"])
