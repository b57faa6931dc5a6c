# A tiny DynamicConvNeXt + UPer + FCN supernet for the benchmark's CPU
# tests: the repository's ConvNeXt-B UPerNet and ADE20K files at small
# widths, with the exact GELU of the published block. Stochastic depth is
# off, so the feature tests can run the backbone in training outside a
# train step; test_convnext_part.py trains it at the published 0.4.
_base_ = ['../../configs/_dynamic_/models/upernet_convnext_b.py']
model = dict(
    backbone=dict(dims=(8, 16, 24, 32), depths=(2, 2, 3, 2),
                  drop_path_rate=0.0),
    decode_head=dict(in_channels=[8, 16, 24, 32], channels=16,
                     num_classes=7),
    auxiliary_head=dict(in_channels=24, channels=8, num_classes=7))
MAXN = {'name': 'MAX', 'arch.backbone.body.width': [8, 16, 24, 32],
        'arch.backbone.body.depth': [2, 2, 3, 2]}
MINN = {'name': 'MIN', 'arch.backbone.body.width': [4, 8, 12, 16],
        'arch.backbone.body.depth': [1, 1, 2, 1]}
train_sampler = dict(
    type='concat',
    model_samplers=[
        dict(type='anchor', anchors=[MAXN, MINN]),
        dict(type='repeat', times=2, model_sampler=dict(
            type='composite', model_samplers=[
                dict(type='range', key='arch.backbone.body.width',
                     start=[4, 8, 12, 16], end=[8, 16, 24, 32],
                     step=[1, 2, 3, 4]),
                dict(type='range', key='arch.backbone.body.depth',
                     start=[1, 1, 2, 1], end=[2, 2, 3, 2],
                     step=[1, 1, 1, 1])]))])
val_sampler = dict(type='anchor', anchors=[MINN, MAXN])
crop_size = (64, 64)
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
train_pipeline = [
    dict(type='Resize', img_scale=(256, 64), ratio_range=(0.5, 2.0)),
    dict(type='RandomCrop', crop_size=crop_size, cat_max_ratio=0.75),
    dict(type='RandomFlip', prob=0.5),
    dict(type='PhotoMetricDistortion'),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
]
data = dict(samples_per_gpu=4, train=dict(pipeline=train_pipeline),
            val=None)
runner = dict(type='IterBasedRunner', max_iters=1000)
lr_config = dict(warmup_iters=10)
optimizer = dict(lr=1e-3)
log_config = dict(interval=5)
