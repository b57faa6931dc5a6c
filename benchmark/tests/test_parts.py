"""The reference's parts (``reference/parts/``): every component type of
the cells is found by name, a new part is one new file, and the move of
the two families into parts changed no number.

The constants were recorded at the commit before the move, where the
reference was one module (``reference/nets.py``) and the MAC counter held
each backbone's and head's count itself, on the CPU (PyTorch's 2.13 CPU
build) with one thread and deterministic algorithms. The moved code has to
give each exactly: MACs as integers, losses by their float32 bits, lists
and per-leaf values by the SHA-256 of their canonical JSON (``_digest``),
per-leaf floats as float32 bits.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import spec as bench_spec  # noqa: E402
from benchmark.lib.macs import model_macs  # noqa: E402
from benchmark.lib.records import make_records  # noqa: E402
from benchmark.lib.weights import seeded_weights  # noqa: E402
from benchmark.loops.common import program_config  # noqa: E402
from benchmark.reference import nets, parts, schedule  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.tests import cases  # noqa: E402

CPU = torch.device("cpu")
SPEC = bench_spec.load_spec()
SEED = 5

LAYOUT = {
    "psp": {"n_specs": 112, "n_bn": 36,
            "param_specs": "75ea4971e24bf51f45af40e12b1f3a09"
                           "a6daf3e5b50d9f0eecfe4d47a923fb97",
            "bn_names": "750cf3724b4f3be5a1f03e8db82fe62c"
                        "0066e2caa43a8b9e723e40b42cc97cf1",
            "max_arch": {"backbone": {
                "stem": {"width": 16},
                "body": {"width": [8, 16, 24, 32], "depth": [2, 2, 3, 2]}}}},
    "vit": {"n_specs": 111, "n_bn": 13,
            "param_specs": "1a9416ffd0fa31e912ddd52fb2ff2db4"
                           "f872ad65da35e80863658d67e2ff4ca8",
            "bn_names": "8d9f45f627d1d2d41caf4c28ea2f2172"
                        "9dfa2fe45bcfb5fe4c8f44083fbfe0ce",
            "max_arch": {"backbone": {
                "embedding": {"width": 128},
                "encoder": {"depth": 4, "num_heads": [2, 2, 2, 2],
                            "ffn_channels": [256, 256, 256, 256]}}}},
}

# (train, inference) MACs of one crop: MAX, the train sampler's MIN anchor,
# and the first 8 draws of every sampler of the cell's config
MACS = {
    "psp-sandwich-cached": {
        "MAX": (179076595712, 173026836480),
        "MIN": (29536026624, 25902186496),
        "train_sampler.0": (179076595712, 173026836480),
        "train_sampler.1": (29536026624, 25902186496),
        "train_sampler.2": (96058212352, 91216412672),
        "train_sampler.3": (77804601344, 72962801664),
        "train_sampler.4": (57269288960, 52427489280),
        "train_sampler.5": (44673794048, 39831994368),
        "train_sampler.6": (101576343552, 95526584320),
        "train_sampler.7": (74743283712, 71109443584),
        "val_sampler.0": (57269288960, 52427489280),
        "val_sampler.1": (77804601344, 72962801664),
        "val_sampler.2": (96058212352, 91216412672),
        "val_sampler.3": (57269288960, 52427489280),
        "val_sampler.4": (77804601344, 72962801664),
        "val_sampler.5": (96058212352, 91216412672),
        "val_sampler.6": (57269288960, 52427489280),
        "val_sampler.7": (77804601344, 72962801664),
    },
    "vit-sandwich-ade": {
        "MAX": (445214115840, 443362854912),
        "MIN": (379210444800, 377359183872),
        "train_sampler.0": (445214115840, 443362854912),
        "train_sampler.1": (379210444800, 377359183872),
        "train_sampler.2": (379210444800, 377359183872),
        "train_sampler.3": (408584862720, 406733601792),
        "train_sampler.4": (445214115840, 443362854912),
        "train_sampler.5": (379210444800, 377359183872),
        "train_sampler.6": (379210444800, 377359183872),
        "train_sampler.7": (408584862720, 406733601792),
        "val_sampler.0": (379210444800, 377359183872),
        "val_sampler.1": (445214115840, 443362854912),
        "val_sampler.2": (379210444800, 377359183872),
        "val_sampler.3": (445214115840, 443362854912),
        "val_sampler.4": (379210444800, 377359183872),
        "val_sampler.5": (445214115840, 443362854912),
        "val_sampler.6": (379210444800, 377359183872),
        "val_sampler.7": (445214115840, 443362854912),
    },
}

# the reference's first two steps and the full step 1 of the tiny configs
# at seed 5, on 12 records of the family's train-step traffic
STEPS = {
    "psp": {"losses": ["401068f8", "40109974"],
            "grad_norms": "dc54040a8105a126335cec1991ab1912"
                          "40f767a7f26bc9243b0db620ed4f81bb",
            "change_norms": "10e3b5249844ef991f5867ffc87c0a6b"
                            "6aa4229a07e05df6b398f934db570691",
            "stats_delta": "cf7b28fe74e210621e9f5a0738ce72ea"
                           "99a26cd93ea0abaffffb71fbffb024bb"},
    "vit": {"losses": ["402f33a2", "402e3d83"],
            "grad_norms": "c437d40ff3cac54b9784598fe83fdd07"
                          "5b390f60a70e7fbe043002588bf8dc0c",
            "change_norms": "a02167ea5900f79c2b1340023af82df1"
                            "1ee6bde4006f87b2c9027a77236367ed",
            "stats_delta": "99956f7a8ca6fcbd28a4a73f35d02fb5"
                           "dfbd29f3ff95d1c59c46b9591da42a5e"},
}


def _bits(v: float) -> str:
    return "%08x" % struct.unpack("<I", struct.pack("<f", v))[0]


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, separators=(
        ",", ":")).encode()).hexdigest()


def _tiny(name):
    cfg = program_config({"repo_configs": [cases.load(name)["tiny"]],
                          "overrides": {}})
    return cfg, cfg.to_dict()["model"]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.set_num_threads(threads)
    torch.use_deterministic_algorithms(deterministic)


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_layout_did_not_move(name):
    _, model_cfg = _tiny(name)
    specs = [[n, list(s)] for n, s in nets.param_specs(model_cfg)]
    bns = nets.bn_names(model_cfg)
    want = LAYOUT[name]
    assert (len(specs), _digest(specs)) == (want["n_specs"],
                                            want["param_specs"])
    assert (len(bns), _digest(bns)) == (want["n_bn"], want["bn_names"])
    assert schedule.max_arch(model_cfg) == want["max_arch"]


@pytest.mark.parametrize("cell", sorted(MACS))
def test_macs_did_not_move(cell):
    config = bench_spec.load_config(bench_spec.cell(SPEC, cell)["config"])
    cfg = program_config(config)
    d = cfg.to_dict()
    model_cfg, crop = d["model"], tuple(config["crop"])
    template = schedule.max_arch(model_cfg)
    archs = {"MAX": template}
    for key in sorted(k for k in d if k.endswith("_sampler")):
        for i, meta in enumerate(schedule.sampler_metas(d[key], 8)):
            archs[f"{key}.{i}"] = schedule.arch_of(template, meta)
            if meta.get("name") == "MIN" and key == "train_sampler":
                archs.setdefault("MIN", archs[f"{key}.{i}"])
    got = {k: (model_macs(model_cfg, a, crop, train=True),
               model_macs(model_cfg, a, crop, train=False))
           for k, a in archs.items()}
    assert got == MACS[cell]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_first_steps_did_not_move(name, one_thread):
    cfg, model_cfg = _tiny(name)
    traffic = cases.load(name)["train_step"]["traffic"]
    from benchmark.loops.train import reference_config
    plain = reference_config(cfg, model_cfg, traffic)
    classes = int(model_cfg["decode_head"]["num_classes"])
    records = make_records(12, tuple(traffic["record_hw"]), classes, SEED,
                           CPU, zero_label=traffic.get("zero_label", False))
    weights = seeded_weights(nets.param_specs(model_cfg), SEED, CPU)
    ref = ref_train.follow(plain, weights, records, SEED, 2, CPU,
                           nets.Numerics())
    stats = ref_train.full_step_stats(plain, weights, records, SEED, 1, CPU,
                                      nets.Numerics())
    got = {"losses": [_bits(v) for v in ref["losses"]],
           "grad_norms": _digest({k: _bits(v) for k, v in
                                  ref["grad_norms"].items()}),
           "change_norms": _digest({k: _bits(v) for k, v in
                                    ref["change_norms"].items()}),
           "stats_delta": _digest({k: [_bits(x) for x in v.tolist()]
                                   for k, v in stats.items()})}
    assert got == STEPS[name]


# --------------------------------------------------------------------- #
# discovery
# --------------------------------------------------------------------- #
ROLE_OF = {"backbone": "backbone", "neck": "neck", "decode_head": "head",
           "auxiliary_head": "head"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_type_of_the_cells_resolves_to_a_part(cell):
    config = bench_spec.load_config(bench_spec.cell(SPEC, cell)["config"])
    model_cfg = program_config(config).to_dict()["model"]
    for key, role in ROLE_OF.items():
        if model_cfg.get(key):
            part = parts.get(model_cfg[key]["type"], role)
            assert model_cfg[key]["type"] in part.TYPES


TOY = '''
from benchmark.reference.nets import cls_seg, conv_bn_relu

TYPES = ("ToyHead",)
ROLE = "head"


def specs(head, chans, S, name):
    S.cbr(f"{name}.toy", chans[head["in_index"]], int(head["channels"]), 1)
    S.cls_seg(name, head)


def forward(nm, P, feats, head, train, stats, gen, name):
    x = conv_bn_relu(nm, P, f"{name}.toy", feats[head["in_index"]], train,
                     stats)
    return cls_seg(nm, P, name, x, head, train, gen)


def macs(head, feats):
    c, hw = feats[head["in_index"]]
    ch = int(head["channels"])
    return hw[0] * hw[1] * (c * ch + ch * int(head["num_classes"]))
'''


def test_a_new_part_is_one_new_file(tmp_path, monkeypatch):
    """A toy head in a directory of its own is found there; registered
    beside the parts, a segmentor with it lays out, counts and runs with
    no other file changed."""
    (tmp_path / "toy_head.py").write_text(TOY)
    found = parts.load(str(tmp_path))
    assert list(found) == ["ToyHead"]
    assert parts.get("ToyHead", "head", str(tmp_path)) is found["ToyHead"]
    monkeypatch.setitem(parts.load(), "ToyHead", found["ToyHead"])
    _, model_cfg = _tiny("psp")
    model_cfg["decode_head"] = {"type": "ToyHead", "in_index": 3,
                                "channels": 4, "num_classes": 5,
                                "dropout_ratio": 0.0,
                                "loss_decode": {"loss_weight": 1.0}}
    specs = dict(nets.param_specs(model_cfg))
    assert specs["decode_head.toy.conv.weight"] == (4, 128, 1, 1)
    assert "decode_head.toy.bn" in nets.bn_names(model_cfg)
    arch = schedule.max_arch(model_cfg)
    assert model_macs(model_cfg, arch, (64, 64), train=False) > 0
    weights = seeded_weights(list(specs.items()), SEED, CPU)
    with torch.no_grad():
        feats = nets.features(nets.Numerics(), weights,
                              torch.randn(2, 3, 64, 64), arch, model_cfg,
                              True)
        (logits, _), _ = nets.head_logits(nets.Numerics(), weights, feats,
                                          model_cfg, True, None, None, True)
    assert logits.shape == (2, 5, 2, 2)


def test_a_type_claimed_twice_raises(tmp_path):
    for stem in ("one", "two"):
        (tmp_path / f"{stem}.py").write_text(
            'TYPES = ("TwiceHead",)\nROLE = "head"\n')
    with pytest.raises(ValueError, match="TwiceHead.*claimed by both"):
        parts.load(str(tmp_path))


def test_an_unknown_type_raises_with_its_name_and_directory():
    with pytest.raises(ValueError) as err:
        parts.get("NoSuchHead", "head")
    assert "NoSuchHead" in str(err.value)
    assert parts.PARTS_DIR in str(err.value)


def test_a_part_in_the_wrong_role_raises():
    with pytest.raises(ValueError, match="is a head, not a backbone"):
        parts.get("DynamicPSPHead", "backbone")
