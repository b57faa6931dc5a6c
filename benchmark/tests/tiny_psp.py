# A tiny DynamicResNet + PSP + FCN supernet for the benchmark's CPU tests:
# the repository's tiny config at crops large enough that batch norm over
# the deepest stage sees more than one value a channel.
_base_ = ['../../configs/tests/tiny_synthetic.py']
crop_size = (128, 128)
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
train_pipeline = [
    dict(type='Resize', img_scale=(192, 160), ratio_range=(0.8, 1.2)),
    dict(type='RandomCrop', crop_size=crop_size, cat_max_ratio=0.75),
    dict(type='RandomFlip', prob=0.5),
    dict(type='PhotoMetricDistortion'),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
]
data = dict(samples_per_gpu=4, train=dict(pipeline=train_pipeline))
runner = dict(type='IterBasedRunner', max_iters=1000)
log_config = dict(interval=5)
# a small step: at these sizes batch norm over the deepest maps sees a few
# values a channel, and a large step makes the next ones chaotic
optimizer = dict(lr=0.001)
