# A tiny elastic ViT + MLN neck + UPer + FCN supernet for the benchmark's
# CPU tests: the repository's ViT and ADE20K files at small widths.
_base_ = ['../../configs/_dynamic_/models/upernet_elastic_vit.py',
          '../../configs/_dynamic_/datasets/ade20k.py']
model = dict(
    backbone=dict(embed_dim=128, depth=4, num_heads=2, ffn_ratio=2.0,
                  img_size=64, out_indices=(0, 1, 2, 3)),
    neck=dict(in_channels=[128, 128, 128, 128], out_channels=32),
    decode_head=dict(in_channels=[32, 32, 32, 32], channels=16,
                     num_classes=7),
    auxiliary_head=dict(in_channels=32, channels=8, num_classes=7))
embed_width_range = dict(key='arch.backbone.embedding.width',
                         start=64, end=128, step=64)
depth_range = dict(key='arch.backbone.encoder.depth', start=2, end=4,
                   step=1)
MAXV = {'name': 'MAX', 'arch.backbone.embedding.width': 128,
        'arch.backbone.encoder.depth': 4}
MINV = {'name': 'MIN', 'arch.backbone.embedding.width': 64,
        'arch.backbone.encoder.depth': 2}
train_sampler = dict(
    type='concat',
    model_samplers=[
        dict(type='anchor', anchors=[MAXV, MINV]),
        dict(type='repeat', times=2, model_sampler=dict(
            type='composite', model_samplers=[
                dict(type='range', **embed_width_range),
                dict(type='range', **depth_range)]))])
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
