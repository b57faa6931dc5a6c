"""A JAX ``DynamicResNet(scan_blocks=True)`` through the port's converter.

JAX's ``scan_blocks`` stacks each stage's tail blocks on a leading depth
axis (``layer{s}.blocks.b.*``, run by ``nn.scan``); ``engine/convert.py``
unstacks them into the unrolled ``layer{s}.{b}`` layout the port's
``DynamicResNet`` has (the port runs blocks unrolled; the builder drops the
``scan_blocks`` key). On seeded variables of JAX's own test net
(``tests/test_backbones2.py`` ``test_resnet_scan_blocks_variant``: stem 8,
widths 8/8/16/16, depths 3/2/2/2) the port's stage outputs equal JAX's run
in float64 (eval-mode BN, running statistics) within 1e-6 of each
output's max, at MAX and at a shallower, narrower arch; and the unstacked
state dict equals the one converted from the same weights in JAX's
unrolled layout.
"""
import gaiaseg_tpu.ops.dynamic_layers as j_layers_module
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaiaseg_tpu.models import build_backbone as j_build_backbone
from gaiaseg_tpu_torch.engine.convert import backbone_state_dict
from gaiaseg_tpu_torch.models import build_backbone
from test_torch_deeplab import _Float64Numpy, close, nchw, seeded

torch.set_num_threads(1)
F64_RTOL = 1e-6
CFG = dict(type="DynamicResNet", stem_width=8, body_width=(8, 8, 16, 16),
           body_depth=(3, 2, 2, 2), out_indices=(0, 1, 2, 3))
ARCHS = {
    "max": {"stem": {"width": 8}, "body": {"width": [8, 8, 16, 16],
                                           "depth": [3, 2, 2, 2]}},
    "sub": {"stem": {"width": 8}, "body": {"width": [4, 8, 8, 16],
                                           "depth": [1, 2, 1, 2]}},
}


def _jax_arch(arch):
    return {"stem": {"width": jnp.asarray(arch["stem"]["width"])},
            "body": {k: jnp.asarray(v) for k, v in arch["body"].items()}}


@pytest.fixture(scope="module")
def scanned():
    """Seeded variables of the scan_blocks net, and JAX's float64 stage
    outputs at each arch."""
    x = np.random.RandomState(0).randn(2, 32, 32, 3)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(j_layers_module, "jnp", _Float64Numpy())
        jbb = j_build_backbone(dict(CFG, scan_blocks=True,
                                    dtype=jnp.float64))
        shapes = jax.eval_shape(lambda: jbb.init(
            jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
            _jax_arch(ARCHS["max"])))
        rng = np.random.RandomState(2)
        variables = jax.tree_util.tree_map_with_path(
            lambda p, s: seeded(s.shape, [getattr(q, "key", q) for q in p],
                                rng), shapes)
        outs = {name: [np.asarray(o) for o in jbb.apply(
            variables, jnp.asarray(x), _jax_arch(arch))]
            for name, arch in ARCHS.items()}
    return dict(x=x, variables=variables, outs=outs)


def test_layout_is_stacked(scanned):
    blocks = scanned["variables"]["params"]["layer1"]["blocks"]["b"]
    assert blocks["conv1"]["kernel"].shape[0] == 2     # depth 3: 2 tail
    assert "block1" not in scanned["variables"]["params"]["layer1"]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_scan_blocks_resnet_matches_jax(scanned, name):
    v = scanned["variables"]
    sd = backbone_state_dict(v["params"], v["batch_stats"], prefix="")
    bb = build_backbone(dict(CFG, scan_blocks=True)).double().eval()
    bb.load_state_dict(sd, strict=True)
    arch = ARCHS[name]
    with torch.no_grad():
        got = bb(nchw(scanned["x"]), arch)
    widths = [4 * w for w in arch["body"]["width"]]
    for i, (g, w) in enumerate(zip(got, scanned["outs"][name])):
        assert g.shape[1] == widths[i] and not w[..., widths[i]:].any()
        close(g.permute(0, 2, 3, 1).numpy(), w[..., :widths[i]],
              f"{name} stage {i}", F64_RTOL)


def test_unstacked_equals_the_unrolled_layout(scanned):
    """The tail block ``i`` of the stack is the unrolled ``block{i+1}``:
    the same weights written in JAX's unrolled layout convert to the same
    state dict."""
    v = scanned["variables"]

    def unroll(tree):
        out = {}
        for stage, layer in tree.items():
            if not stage.startswith("layer"):
                out[stage] = layer
                continue
            tail = layer["blocks"]["b"]
            n = jax.tree_util.tree_leaves(tail)[0].shape[0]
            out[stage] = {"block0": layer["block0"], **{
                f"block{i + 1}": jax.tree_util.tree_map(
                    lambda a, i=i: np.asarray(a)[i], tail)
                for i in range(n)}}
        return out
    stacked = backbone_state_dict(v["params"], v["batch_stats"])
    unrolled = backbone_state_dict(unroll(v["params"]),
                                   unroll(v["batch_stats"]))
    assert stacked.keys() == unrolled.keys()
    assert "backbone.layer1.2.conv3.weight" in stacked
    for k in stacked:
        assert torch.equal(stacked[k], unrolled[k]), k
