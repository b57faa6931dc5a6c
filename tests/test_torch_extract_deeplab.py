"""Extraction and FLOPs of the v1c and DeepLabV3+ supernets against JAX.

The two scaled-down configs of ``test_torch_deeplab.py`` (the v1c one with
a 3-list deep stem, a PSP head and an FCN aux head with ``conv_cat``; the
DeepLabV3+ one with the separable ASPP head), seeded JAX variables
converted by ``engine/convert.py``.

- ``subnet_model_cfg``: JAX's config, except that each head's
  ``in_channels`` (and the DeepLabV3+ head's ``c1_in_channels``) is the
  subnet's; a 3-list stem width stays a list.
- Extraction: JAX's extracted variables, converted, equal the port's
  extraction bit for bit (the stem's three convs, the ``conv_cat`` rows
  ``[a, ch]`` of the aux head's input axis, the ASPP's leading slices).
- The extracted subnet equals the port's supernet at the arch bit for bit
  (CPU, float32) and JAX's logits at the arch within 1e-4 of max|ref|
  (DeepLabV3+ under ROADMAP C9's rule: inactive ``dw_bn`` lanes at bias 0,
  statistics (0, 1)).
- An FCN head under ``resize_concat`` with ``conv_cat`` extracts to a
  subnet equal to the supernet (the rows of each stage's active channels).
- FLOPs and parameters of the repo's DeepLabV3+ and v1c configs equal
  JAX's ``get_model_complexity_info`` at MAX, MIN, the v1c anchors and
  sampled archs; for the v1c config they equal the built subnet's
  parameter count (the DeepLabV3+ head is not counted, ROADMAP C10).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace.complexity import \
    get_model_complexity_info as j_complexity
from gaiaseg_tpu.engine.extract import extract_subnet as j_extract_subnet
from gaiaseg_tpu.engine.extract import subnet_model_cfg as j_subnet_model_cfg
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.archspace import build_model_sampler, \
    get_model_complexity_info
from gaiaseg_tpu_torch.engine import extract_subnet, subnet_model_cfg
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.models.arch_util import canonical_arch
from gaiaseg_tpu_torch.utils import Config

from test_torch_deeplab import (METAS, active_lanes, dw_bn_lanes, model_cfg,
                                seeded_variables)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = os.path.join(REPO, "configs", "_dynamic_", "models")
JAX_RTOL = 1e-4
SUB_METAS = {
    "deeplab": dict(METAS["deeplab"], name="sub"),
    "v1c": dict(METAS["v1c"], name="sub"),
}


@pytest.fixture(scope="module", params=["deeplab", "v1c"])
def supernet(request):
    kind = request.param
    jcfg = model_cfg(kind, True)
    jmodel = j_build_segmentor(jcfg)
    variables = seeded_variables(jmodel, jcfg)
    if kind == "deeplab":
        variables = dw_bn_lanes(variables, active_lanes(kind, True))
    cfg = model_cfg(kind, False)
    sd = variables_to_state_dict(variables, cfg)
    model = build_segmentor(cfg)
    model.load_state_dict(sd, strict=True)
    img = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    return dict(kind=kind, jcfg=jcfg, jmodel=jmodel, variables=variables,
                cfg=cfg, sd=sd, model=model.eval(), img=img)


def _nchw(img):
    return torch.from_numpy(img.transpose(0, 3, 1, 2).copy())


def test_subnet_model_cfg_matches_jax_but_in_channels(supernet):
    cfg, kind = supernet["cfg"], supernet["kind"]
    arch = canonical_arch(model_max_arch(cfg), SUB_METAS[kind])
    got = subnet_model_cfg(cfg, arch)
    want = j_subnet_model_cfg(cfg, arch)
    widths = arch["backbone"]["body"]["width"]
    assert got["decode_head"].pop("in_channels") == widths[3] * 4
    if kind == "deeplab":
        assert got["decode_head"].pop("c1_in_channels") == widths[0] * 4
    assert got["auxiliary_head"].pop("in_channels") == widths[2] * 4
    assert got == want
    assert got["backbone"]["stem_width"] == \
        SUB_METAS[kind]["arch.backbone.stem.width"]


def test_extraction_equals_jax_bit_for_bit(supernet):
    kind = supernet["kind"]
    meta = SUB_METAS[kind]
    _, j_vars, j_arch = j_extract_subnet(supernet["jcfg"],
                                         supernet["variables"], meta,
                                         img_size=(32, 32))
    sub_cfg, sub_sd, arch = extract_subnet(supernet["cfg"], supernet["sd"],
                                           meta)
    assert arch == j_arch
    want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          j_vars), sub_cfg)
    assert set(sub_sd) == set(want)
    for key, t in want.items():
        assert torch.equal(sub_sd[key], t), key
    if kind == "v1c":           # conv_cat: [x's active rows, the tail]
        w = supernet["sd"]["auxiliary_head.conv_cat.conv.weight"]
        got = sub_sd["auxiliary_head.conv_cat.conv.weight"]
        a = meta["arch.backbone.body.width"][2] * 4
        assert got.shape[1] == a + 8 and torch.equal(got[:, :a], w[:, :a]) \
            and torch.equal(got[:, a:], w[:, -8:])
        assert sub_sd["backbone.stem.0.weight"].shape[0] == 2


def test_extracted_subnet_equals_the_supernet_and_jax(supernet):
    kind = supernet["kind"]
    meta = SUB_METAS[kind]
    sub_cfg, sub_sd, _ = extract_subnet(supernet["cfg"], supernet["sd"],
                                        meta)
    sub = build_segmentor(sub_cfg)
    sub.load_state_dict(sub_sd, strict=True)
    x = _nchw(supernet["img"])
    with torch.no_grad():
        got = sub.eval().whole_inference(x, encode_arch(model_max_arch(
            sub_cfg)))
        ref = supernet["model"].whole_inference(x, encode_arch(
            model_max_arch(supernet["cfg"]), meta))
    assert torch.equal(got, ref)
    jcfg, jmodel = supernet["jcfg"], supernet["jmodel"]
    want = np.asarray(jax.jit(lambda a: jmodel.apply(
        supernet["variables"], jnp.asarray(supernet["img"]), a,
        method=jmodel.whole_inference))(j_encode_arch(j_model_max_arch(jcfg),
                                                      meta)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0,
                               atol=JAX_RTOL * float(np.abs(want).max()))


def test_resize_concat_fcn_subnet_equals_the_supernet():
    cfg = model_cfg("deeplab", False)
    cfg["auxiliary_head"] = dict(
        cfg["auxiliary_head"], in_index=[1, 2, 3],
        input_transform="resize_concat", concat_input=True)
    torch.manual_seed(0)
    model = build_segmentor(cfg).eval()
    for m in model.modules():          # non-trivial statistics
        if hasattr(m, "running_var"):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    meta = METAS["deeplab"]
    sub_cfg, sub_sd, _ = extract_subnet(cfg, model.state_dict(), meta)
    widths = meta["arch.backbone.body.width"]
    assert sub_cfg["auxiliary_head"]["in_channels"] == \
        [w * 4 for w in widths[1:]]
    sub = build_segmentor(sub_cfg)
    sub.load_state_dict(sub_sd, strict=True)
    sub.eval()
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        want = model.auxiliary_head(model.extract_feat(
            x, encode_arch(model_max_arch(cfg), meta)))
        got = sub.auxiliary_head(sub.extract_feat(
            x, encode_arch(model_max_arch(sub_cfg))))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def _full_cfg(name):
    return Config.fromfile(os.path.join(MODELS, name))["model"]


def _metas(cfg):
    widths = cfg["backbone"]["body_width"]
    depths = cfg["backbone"]["body_depth"]
    stem = model_max_arch(cfg)["backbone"]["stem"]["width"]
    rng = np.random.RandomState(0)
    metas = [None, {"arch.backbone.body.width": [w // 2 for w in widths],
                    "arch.backbone.body.depth": [1, 1, 1, 1]}]
    for _ in range(4):
        metas.append({
            "arch.backbone.stem.width": [int(rng.randint(s // 2, s + 1))
                                         for s in stem]
            if isinstance(stem, list) else int(rng.randint(stem // 2,
                                                           stem + 1)),
            "arch.backbone.body.width": [int(rng.randint(w // 2, w + 1))
                                         for w in widths],
            "arch.backbone.body.depth": [int(rng.randint(1, d + 1))
                                         for d in depths]})
    return metas


@pytest.mark.parametrize("name", ["deeplabv3plus_ar50to101v2.py",
                                  "pspnet_ar50to101_v1c.py"])
def test_complexity_equals_jax(name):
    cfg = _full_cfg(name)
    metas = _metas(cfg)
    if "v1c" in name:
        extract_cfg = Config.fromfile(os.path.join(
            REPO, "configs", "local_examples", "extract_subnet",
            "psp_ar50to101_v1c_extract.py"))
        metas += list(build_model_sampler(
            extract_cfg["train_sampler"]).traverse())
    for meta in metas:
        arch = canonical_arch(model_max_arch(cfg), meta)
        for only_backbone in (False, True):
            got = get_model_complexity_info(cfg, arch, (3, 512, 1024),
                                            only_backbone)
            want = j_complexity(cfg, arch, (3, 512, 1024), only_backbone)
            assert got == want, meta


def test_v1c_analytic_params_count_the_built_subnet():
    cfg = _full_cfg("pspnet_ar50to101_v1c.py")
    for meta in _metas(cfg):
        arch = canonical_arch(model_max_arch(cfg), meta)
        with torch.device("meta"):
            sub = build_segmentor(subnet_model_cfg(cfg, arch))
        want = get_model_complexity_info(cfg, arch, (3, 512, 1024))["params"]
        assert sum(p.numel() for p in sub.parameters()) == want, meta
