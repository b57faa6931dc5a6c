"""``update_host_ms.train`` in the ViT cell, which reports its rate as
``train_img_per_s.vit``: the same reader."""
from benchmark.lib.spec import metric_reader

read = metric_reader("update_host_ms.train").read
