"""The segmentor's inference modes against the JAX package.

On the same weights (carried by ``variables_to_state_dict``), float32:
- ``slide_inference`` on unaligned grids (40x56 with crop 32 and strides
  20/24, a crop wider than the image, a crop smaller in both directions):
  logits within 1e-4 of max|logit| of JAX's ``slide_inference``;
- ``inference(flip=True)`` probabilities (whole and slide) within 1e-4 of
  JAX's; ``simple_test(flip=True)`` and ``simple_test`` in slide mode give
  JAX's classes; ``aug_test`` at ratios (0.75, 1.0), with and without flip,
  gives JAX's classes;
- the inference modes need eval mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu.ops.resize import resize_bilinear as j_resize
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.ops.resize import resize_bilinear

from test_torch_segmentor import METAS, model_cfg

torch.set_num_threads(1)
RTOL = 1e-4
SLIDE = dict(mode="slide", crop_size=(24, 32), stride=(16, 20))


def cfgs(test_cfg=None):
    """(JAX config, port config) of the test model with ``test_cfg``."""
    out = []
    for jax_side in (True, False):
        cfg = model_cfg(jax_side)
        if test_cfg is not None:
            cfg["test_cfg"] = dict(test_cfg)
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def weights():
    cfg = model_cfg(True)
    model = j_build_segmentor(cfg)
    rng = np.random.RandomState(0)
    img = rng.randn(2, 40, 56, 3).astype(np.float32)
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda a: model.init(
        {"params": k, "dropout": k}, jnp.asarray(img),
        jnp.zeros((2, 40, 56), jnp.int32), a, compute_acc=False,
        method="forward_train"))(j_encode_arch(j_model_max_arch(cfg)))
    return jax.tree_util.tree_map(np.asarray, variables), img


def models(weights, test_cfg=None):
    """(JAX model, its variables, port model in eval mode, img NHWC)."""
    variables, img = weights
    jcfg, cfg = cfgs(test_cfg)
    model = build_segmentor(cfg)
    model.load_state_dict(variables_to_state_dict(variables, cfg))
    return j_build_segmentor(jcfg), variables, model.eval(), img


def archs(meta=None):
    return (j_encode_arch(j_model_max_arch(model_cfg(True)), meta),
            encode_arch(model_max_arch(model_cfg(False)), meta))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("crop,stride", [((32, 32), (20, 24)),
                                         ((24, 64), (16, 16)),
                                         ((16, 24), (12, 10))])
def test_slide_inference_matches_jax(weights, crop, stride):
    jmodel, variables, model, img = models(weights)
    jarch, arch = archs(METAS["random"])
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img), jarch, crop,
                                   stride, method=jmodel.slide_inference))
    with torch.no_grad():
        got = model.slide_inference(nchw(img), arch, crop, stride)
    assert got.dtype == torch.float32
    _close(got.permute(0, 2, 3, 1).numpy(), want, f"slide {crop} {stride}")


@pytest.mark.parametrize("test_cfg", [None, SLIDE], ids=["whole", "slide"])
def test_flip_inference_matches_jax(weights, test_cfg):
    jmodel, variables, model, img = models(weights, test_cfg)
    jarch, arch = archs(METAS["max"])
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img), jarch, True,
                                   method=jmodel.inference))
    want_cls = np.asarray(jmodel.apply(variables, jnp.asarray(img), jarch,
                                       True, method=jmodel.simple_test))
    with torch.no_grad():
        got = model.inference(nchw(img), arch, flip=True)
        got_cls = model.simple_test(nchw(img), arch, flip=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=RTOL)
    np.testing.assert_array_equal(got_cls.numpy(), want_cls)


def test_slide_simple_test_matches_jax(weights):
    jmodel, variables, model, img = models(weights, SLIDE)
    jarch, arch = archs(METAS["min"])
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img), jarch,
                                   method=jmodel.simple_test))
    with torch.no_grad():
        got = model.simple_test(nchw(img), arch)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flip", [False, True])
def test_aug_test_matches_jax(weights, flip):
    jmodel, variables, model, img = models(weights, SLIDE)
    jarch, arch = archs(METAS["max"])
    h, w = img.shape[1:3]
    sizes = [(round(h * r), round(w * r)) for r in (0.75, 1.0)]
    jimgs = [j_resize(jnp.asarray(img), s) for s in sizes]
    want = np.asarray(jmodel.apply(variables, jimgs, jarch, flip,
                                   method=jmodel.aug_test, out_hw=(h, w)))
    with torch.no_grad():
        imgs = [resize_bilinear(nchw(img), s) for s in sizes]
        got = model.aug_test(imgs, arch, flip, out_hw=(h, w))
    assert tuple(got.shape) == (2, h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_inference_needs_eval_mode(weights):
    _, _, model, img = models(weights, SLIDE)
    model.train()
    _, arch = archs()
    for call in (lambda: model.slide_inference(nchw(img), arch, (24, 32),
                                               (16, 20)),
                 lambda: model.simple_test(nchw(img), arch),
                 lambda: model.inference(nchw(img), arch, flip=True)):
        with pytest.raises(RuntimeError, match="eval mode"):
            call()
