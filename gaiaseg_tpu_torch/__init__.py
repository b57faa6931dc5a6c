"""gaiaseg_tpu_torch: the PyTorch/CUDA port of gaiaseg_tpu.

A second package beside the JAX one, driven by the same config files. It
imports torch and numpy only — never jax or any module of ``gaiaseg_tpu`` —
and keeps its own copies of the JAX-free host code it needs.

- ``utils``, ``archspace``: registries, config loader, arch samplers,
  model spaces and their rules, the restartable sweep log.
- ``ops``: sliced dynamic layers (elasticity by prefix slices of MAX-shape
  parameters) and the hand-written CUDA kernels under ``ops/cuda`` with their
  sources in ``csrc/``.
- ``models``: DynamicResNet (with the v1c deep stem, avg_down and
  dilated stages), ElasticTransformer, the neck, PSP/FCN/UPer/ASPP and
  DeepLabV3+ heads, CE (softmax or sigmoid, class weights, reductions), the segmentor (whole and slide inference, flip and
  multi-scale TTA).
- ``engine``: SGD / Adam / AdamW + LR schedules and frozen stages, the supernet train step and the
  loop around it (BN calibration, ``.pth`` checkpoints and resume, the val
  workflow, the in-loop cross-arch eval), evaluation (one subnet, the
  anchors, a population), the inference API, weight conversion from the
  JAX package's variables; ``apis`` keeps the reference's names.
- ``tools``: the ``train_supernet`` and ``test_supernet`` CLIs, dataset
  packing, probes and kernel-build comparisons.
- ``data``, ``native``: file, packed (a C++ mmap reader) and device-cached
  datasets, the loader and prefetch feed, the train pipeline's
  augmentation on the device, the confusion-matrix mIoU.
"""

__version__ = "0.1.0"
