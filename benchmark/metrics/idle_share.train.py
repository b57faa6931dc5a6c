"""Device (H100): the share of the profiled cycles' wall time in which no
operation ran on the card, in %."""


def read(r):
    span = r.get("span") if r.get("kind") == "train" else None
    if not span or span["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - span["busy_s"] / span["wall_s"])
