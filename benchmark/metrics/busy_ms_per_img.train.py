"""Train step (``train_step``, the models, the optimizer): device busy
time (the union of the device's operations in the profiled cycles), in ms
an image."""


def read(r):
    span = r.get("span") if r.get("kind") == "train" else None
    if not span or span["busy_s"] <= 0:
        return None
    return 1e3 * span["busy_s"] / r["span_images"]
