# ConvNeXt-B supernet + UPerHead + FCN aux head on ADE20K: mmseg v0.30.0
# configs/convnext/upernet_convnext_base_fp16_512x512_160k_ade20k.py (the
# mmcls ConvNeXt arch 'base', Liu et al., arXiv:2201.03545) at its
# published widths, depths, heads, data and schedule. Departures: no
# layer-wise LR decay (the stage-wise 0.9 over 12 layers needs an
# optimizer constructor neither package has); bf16 autocast on the card in
# place of fp16 with a dynamic loss scale; the sandwich sampler below over
# the published net as its MAX.
_base_ = ['../datasets/ade20k.py']
norm_cfg = dict(type='DynSyncBN', group_size=1, requires_grad=True)

model = dict(
    type='DynamicEncoderDecoder',
    backbone=dict(
        type='DynamicConvNeXt',
        dims=(128, 256, 512, 1024),
        depths=(3, 3, 27, 3),
        out_indices=(0, 1, 2, 3),
        drop_path_rate=0.4,
        layer_scale_init_value=1.0,
        gelu='none'),
    decode_head=dict(
        type='DynamicUPerHead',
        in_channels=[128, 256, 512, 1024],
        in_index=(0, 1, 2, 3),
        input_transform='multiple_select',
        pool_scales=(1, 2, 3, 6),
        channels=512,
        dropout_ratio=0.1,
        num_classes=150,
        norm_cfg=norm_cfg,
        align_corners=False,
        loss_decode=dict(type='CrossEntropyLoss', use_sigmoid=False,
                         loss_weight=1.0)),
    auxiliary_head=dict(
        type='DynamicFCNHead',
        in_channels=512,
        in_index=2,
        channels=256,
        num_convs=1,
        concat_input=False,
        dropout_ratio=0.1,
        num_classes=150,
        norm_cfg=norm_cfg,
        align_corners=False,
        loss_decode=dict(type='CrossEntropyLoss', use_sigmoid=False,
                         loss_weight=0.4)),
    train_cfg=dict(),
    test_cfg=dict(mode='slide', crop_size=(512, 512), stride=(341, 341)))

# the sandwich: MAX, MIN (half of every width, depths 2/2/14/2), then two
# draws of widths in steps of an eighth of MAX and depths in steps of 1,
# each from MIN to MAX
width_key = 'arch.backbone.body.width'
depth_key = 'arch.backbone.body.depth'
MAXN = {'name': 'MAX', width_key: [128, 256, 512, 1024],
        depth_key: [3, 3, 27, 3]}
MINN = {'name': 'MIN', width_key: [64, 128, 256, 512],
        depth_key: [2, 2, 14, 2]}
train_sampler = dict(
    type='concat',
    model_samplers=[
        dict(type='anchor', anchors=[MAXN, MINN]),
        dict(type='repeat', times=2, model_sampler=dict(
            type='composite', model_samplers=[
                dict(type='range', key=width_key, start=[64, 128, 256, 512],
                     end=[128, 256, 512, 1024], step=[16, 32, 64, 128]),
                dict(type='range', key=depth_key, start=[2, 2, 14, 2],
                     end=[3, 3, 27, 3], step=[1, 1, 1, 1]),
            ])),
    ])
val_sampler = dict(type='anchor', anchors=[MINN, MAXN])

# 8 GPUs x 2 images in the source: a global batch of 16
data = dict(samples_per_gpu=16)
optimizer = dict(type='AdamW', lr=1e-4, betas=(0.9, 0.999),
                 weight_decay=0.05)
optimizer_config = dict()
lr_config = dict(policy='poly', power=1.0, min_lr=0.0, by_epoch=False,
                 warmup='linear', warmup_iters=1500, warmup_ratio=1e-6)
runner = dict(type='IterBasedRunner', max_iters=160000)
checkpoint_config = dict(by_epoch=False, interval=16000)
evaluation = dict(interval=16000, metric='mIoU')
log_config = dict(interval=50)
