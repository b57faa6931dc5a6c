"""Data feed (``make_train_feed``, the loader, staging, the device cache):
the train loop's wait for its next batch, in ms a step, from the log rows
of ``train_segmentor`` (``data=``) that close inside the timed window."""


def read(r):
    if r.get("kind") != "train":
        return None
    return r.get("data_ms_per_step")
