"""The port's subnet extraction and label surgery against the JAX package.

Tiny supernets (the ResNet of ``configs/tests/tiny_synthetic.py``: stem
16, widths 8/16/24/32, depths 2/2/3/2) with a PSP head, or a UPer head over
all four stages, and an FCN aux head; their JAX variables are seeded numpy
arrays of the JAX model's shapes, converted to a port state dict by
``engine/convert.py``.

- ``subnet_model_cfg``: JAX's config, except that each head's
  ``in_channels`` is the subnet's (``body_width[in_index] * 4``); the port
  builds it.
- Extraction: JAX's extracted variables, converted, and the port's
  extraction of the converted supernet have the same keys and equal bits,
  at a narrower stem, a shallower stage, a narrower last stage (the
  bottleneck's segment rows) and all three at once.
- The extracted subnet at its MAX equals the supernet at the arch (float32,
  CPU, within 1e-6 of max|ref|) and JAX's logits at the arch within
  ``test_torch_segmentor.py``'s 1e-4 of max|ref|; its parameter count
  equals the analytic ``params`` exactly at MAX, MIN and 3 sampled archs.
- ``remap_classifier`` equals JAX's, converted HWIO -> OIHW, bit for bit,
  with fresh (-1) classes at ``init_scale`` 0 and 0.02.
- ``tools/extract_subnet.py`` (``--device cpu``): the files are named as
  JAX's ``subnet_name`` of each nested meta, and each loads strictly into
  a model built from its stored ``model_cfg`` and reproduces the supernet
  at its arch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.archspace import unfold_dict as j_unfold_dict
from gaiaseg_tpu.engine.extract import extract_subnet as j_extract_subnet
from gaiaseg_tpu.engine.extract import subnet_model_cfg as j_subnet_model_cfg
from gaiaseg_tpu.engine.extract import subnet_name as j_subnet_name
from gaiaseg_tpu.engine.label_surgery import \
    remap_classifier as j_remap_classifier
from gaiaseg_tpu.models import build_segmentor as j_build_segmentor
from gaiaseg_tpu.models import encode_arch as j_encode_arch
from gaiaseg_tpu.models import model_max_arch as j_model_max_arch
from gaiaseg_tpu_torch.archspace import (build_model_sampler,
                                         get_model_complexity_info)
from gaiaseg_tpu_torch.engine import (extract_subnet, load_checkpoint,
                                      remap_classifier, save_checkpoint,
                                      subnet_model_cfg)
from gaiaseg_tpu_torch.engine.convert import variables_to_state_dict
from gaiaseg_tpu_torch.models import build_segmentor, encode_arch, \
    model_max_arch
from gaiaseg_tpu_torch.models.arch_util import canonical_arch
from gaiaseg_tpu_torch.tools import extract_subnet as extract_cli
from gaiaseg_tpu_torch.utils import Config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tests", "tiny_synthetic.py")
SUBNET_RTOL = 1e-6    # extracted subnet vs the port's supernet (float32)
JAX_RTOL = 1e-4       # vs the JAX model, as tests/test_torch_segmentor.py


def model_cfg(head: str, jax_side: bool):
    dt = {"dtype": jnp.float32} if jax_side else {}
    ce = dict(type="CrossEntropyLoss")
    decode = dict(type="DynamicPSPHead", in_index=3) if head == "psp" else \
        dict(type="DynamicUPerHead", in_index=(0, 1, 2, 3))
    decode.update(channels=16, pool_scales=(1, 2), dropout_ratio=0.0,
                  num_classes=5, loss_decode=ce, **dt)
    return dict(
        type="DynamicEncoderDecoder",
        backbone=dict(type="DynamicResNet", stem_width=16,
                      body_width=[8, 16, 24, 32], body_depth=[2, 2, 3, 2],
                      out_indices=(0, 1, 2, 3), **dt),
        decode_head=decode,
        auxiliary_head=dict(type="DynamicFCNHead", in_index=2, channels=8,
                            num_convs=1, concat_input=False,
                            dropout_ratio=0.0, num_classes=5, **dt,
                            loss_decode=dict(ce, loss_weight=0.4)),
        test_cfg=dict(mode="whole"))


METAS = {
    "stem": {"name": "stem", "arch.backbone.stem.width": 8},
    "shallow": {"name": "shallow", "arch.backbone.body.depth": [2, 1, 3, 2]},
    "rows": {"name": "rows", "arch.backbone.body.width": [8, 16, 24, 16]},
    "all": {"name": "all", "arch.backbone.stem.width": 8,
            "arch.backbone.body.width": [4, 8, 16, 16],
            "arch.backbone.body.depth": [1, 2, 2, 1]},
}


def _seeded(shape, path, rng):
    """Values of the right kind for each JAX leaf: He-scaled kernels, BN
    scales near 1, positive variances."""
    name = path[-1]
    if name == "kernel":
        return rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
    if name == "var":
        return rng.uniform(0.5, 1.5, shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.randn(*shape)
    return 0.1 * rng.randn(*shape)


@pytest.fixture(scope="module", params=["psp", "uper"])
def supernet(request):
    head = request.param
    jcfg = model_cfg(head, True)
    jmodel = j_build_segmentor(jcfg)
    k = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, 32, 32), jnp.int32), j_encode_arch(j_model_max_arch(
            jcfg)), method="forward_train"))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _seeded(s.shape, [getattr(q, "key", q) for q in p],
                             rng).astype(np.float32), shapes)
    cfg = model_cfg(head, False)
    sd = variables_to_state_dict(variables, cfg)
    model = build_segmentor(cfg)
    model.load_state_dict(sd, strict=True)
    img = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    return dict(head=head, jcfg=jcfg, jmodel=jmodel, variables=variables,
                cfg=cfg, sd=sd, model=model.eval(), img=img)


def _nchw(img):
    return torch.from_numpy(img.transpose(0, 3, 1, 2).copy())


def test_subnet_model_cfg_matches_jax_but_in_channels(supernet):
    cfg = supernet["cfg"]
    for meta in METAS.values():
        arch = canonical_arch(model_max_arch(cfg), meta)
        got = subnet_model_cfg(cfg, arch)
        want = j_subnet_model_cfg(cfg, arch)
        widths = arch["backbone"]["body"]["width"]
        idx = cfg["decode_head"]["in_index"]
        assert got["decode_head"].pop("in_channels") == (
            widths[idx] * 4 if isinstance(idx, int)
            else [widths[i] * 4 for i in idx])
        assert got["auxiliary_head"].pop("in_channels") == widths[2] * 4
        assert got == want
        build_segmentor(subnet_model_cfg(cfg, arch))


@pytest.mark.parametrize("name", sorted(METAS))
def test_extraction_equals_jax_bit_for_bit(supernet, name):
    meta = METAS[name]
    j_cfg, j_vars, j_arch = j_extract_subnet(supernet["jcfg"],
                                             supernet["variables"], meta,
                                             img_size=(32, 32))
    sub_cfg, sub_sd, arch = extract_subnet(supernet["cfg"], supernet["sd"],
                                           meta)
    assert arch == j_arch
    want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          j_vars), sub_cfg)
    assert set(sub_sd) == set(want)
    for key, t in want.items():
        assert sub_sd[key].dtype == t.dtype and torch.equal(sub_sd[key], t), \
            key
    if name in ("rows", "all"):        # the bottleneck's segment rows
        w = supernet["sd"]["decode_head.bottleneck.conv.weight"]
        got = sub_sd["decode_head.bottleneck.conv.weight"]
        a = METAS[name]["arch.backbone.body.width"][3] * 4
        assert got.shape[1] == a + 2 * 16 and torch.equal(
            got[:, :a], w[:, :a]) and torch.equal(got[:, a:], w[:, -32:])


def test_extracted_subnet_equals_the_supernet_and_jax(supernet):
    meta = METAS["all"]
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
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= SUBNET_RTOL * scale
    jcfg, jmodel = supernet["jcfg"], supernet["jmodel"]
    want = np.asarray(jax.jit(lambda a: jmodel.apply(
        supernet["variables"], jnp.asarray(supernet["img"]), a,
        method=jmodel.whole_inference))(j_encode_arch(j_model_max_arch(jcfg),
                                                      meta)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0,
                               atol=JAX_RTOL * float(np.abs(want).max()))


def test_parameter_count_equals_the_analytic_count(supernet):
    cfg = supernet["cfg"]
    tiny = Config.fromfile(TINY)["train_sampler"]["model_samplers"]
    sampler = build_model_sampler(tiny[1]["model_sampler"])
    metas = list(build_model_sampler(tiny[0]).traverse()) + \
        [sampler.sample() for _ in range(3)]
    assert [m.get("name") for m in metas] == ["MAX", "MIN"] + [None] * 3
    for meta in metas:
        sub_cfg, sub_sd, arch = extract_subnet(cfg, supernet["sd"], meta)
        sub = build_segmentor(sub_cfg)
        sub.load_state_dict(sub_sd, strict=True)
        want = get_model_complexity_info(cfg, arch, (3, 32, 32))["params"]
        assert sum(p.numel() for p in sub.parameters()) == want, meta


@pytest.mark.parametrize("ksize", [1, 3])
@pytest.mark.parametrize("init_scale", [0.0, 0.02])
def test_remap_classifier_equals_jax(init_scale, ksize):
    rng = np.random.RandomState(4)
    kernel = rng.randn(ksize, ksize, 6, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    mapping = [3, -1, 0, -1, 4, 4, -1]
    want = j_remap_classifier({"decode_head_m": {"conv_seg": {
        "kernel": kernel, "bias": bias}}, "other": {"x": 1}}, mapping,
        init_scale=init_scale)["decode_head_m"]["conv_seg"]
    other = torch.ones(2)
    sd = {"decode_head.conv_seg.weight":
          torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
          "decode_head.conv_seg.bias": torch.from_numpy(bias),
          "backbone.x": other}
    got = remap_classifier(sd, mapping, init_scale=init_scale)
    assert torch.equal(got["decode_head.conv_seg.weight"], torch.from_numpy(
        want["kernel"].transpose(3, 2, 0, 1).copy()))
    assert torch.equal(got["decode_head.conv_seg.bias"],
                       torch.from_numpy(want["bias"]))
    assert got["backbone.x"] is other and sd["decode_head.conv_seg.weight"] \
        .shape[0] == 5
    fresh = got["decode_head.conv_seg.weight"][[1, 3, 6]]
    assert bool((fresh != 0).all()) == (init_scale > 0)


def test_extract_cli_writes_loadable_subnets(tmp_path):
    cfg = Config.fromfile(TINY)
    torch.manual_seed(0)
    model = build_segmentor(cfg["model"])
    for m in model.modules():        # statistics other than the init's 0/1
        if hasattr(m, "running_var"):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    ckpt = str(tmp_path / "supernet.pth")
    save_checkpoint(ckpt, model, meta={"iter": 1})
    rows = extract_cli.main([TINY, ckpt, "--work-dir", str(tmp_path / "out"),
                             "--sampler-key", "val_sampler", "--device",
                             "cpu", "--smoke-size", "32", "40"])
    metas = list(build_model_sampler(cfg["val_sampler"]).traverse())
    assert [r["name"] for r in rows] == ["MIN", "MAX"]
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"{j_subnet_name(j_unfold_dict(m))}.pth" for m in metas)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    model.eval()
    for meta, row in zip(metas, rows):
        saved = torch.load(row["path"], map_location="cpu",
                           weights_only=False)
        assert saved["meta"]["meta"] == j_unfold_dict(meta)
        sub = build_segmentor(saved["meta"]["model_cfg"])
        load_checkpoint(row["path"], sub, strict=True)
        with torch.no_grad():
            got = sub.eval().whole_inference(x, encode_arch(
                model_max_arch(saved["meta"]["model_cfg"])))
            ref = model.whole_inference(x, encode_arch(
                model_max_arch(cfg["model"]), meta))
        assert float((got - ref).abs().max()) <= \
            SUBNET_RTOL * float(ref.abs().max())
    assert rows[0]["mb"] < rows[1]["mb"]
