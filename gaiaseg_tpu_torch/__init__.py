"""gaiaseg_tpu_torch: the PyTorch/CUDA port of gaiaseg_tpu.

A second package beside the JAX one, driven by the same config files. It
imports torch and numpy only — never jax or any module of ``gaiaseg_tpu`` —
and keeps its own copies of the JAX-free host code it needs.

- ``utils``, ``archspace``: registries, config loader, arch samplers.
- ``ops``: sliced dynamic layers (elasticity by prefix slices of MAX-shape
  parameters) and the hand-written CUDA kernels under ``ops/cuda`` with their
  sources in ``csrc/``.
- ``models``: DynamicResNet, PSP/FCN heads, CE loss, the segmentor.
- ``engine``: SGD + poly LR, the supernet train step and loop, weight
  conversion from the JAX package's variables.
- ``data``, ``native``: file, packed (a C++ mmap reader) and device-cached
  datasets, the loader and prefetch feed, the train pipeline's
  augmentation on the device, the confusion-matrix mIoU.
"""

__version__ = "0.1.0"
