"""Every transform of ``geot_tpu``'s ``DataTransforms`` registry, its
``ListCompose`` and ``Cutmix``'s batch mixing against the port's
(``geot_tpu_torch/data/transforms.py``), and the loader's batch mixers.

Bit-equal throughout: each transform runs on its own copy of the same item
with a generator of the same seed, and the items after it (every entry's
dtype and bytes) and the generators' states after it are equal; so are
``Cutmix.mix_batch``'s batches (mixed in place) and the loaders' batches
with 1 and 4 worker threads.
"""
import copy

import numpy as np
import pytest

from geot_tpu.data import build as jbuild
from geot_tpu.data import transforms as jtf

from geot_tpu_torch.data import build as tbuild
from geot_tpu_torch.data import transforms as ttf

from test_torch_heritage_data import assert_batches_equal, assert_items_equal

# keyword sets per transform beyond the defaults: the branches each takes
VARIANTS = {
    "PointCloudCenterAndNormalize": [{"append_xyz": True},
                                     {"centering": False, "normalize": False,
                                      "gravity_dim": 1}],
    "PointCloudScaling": [{"anisotropic": False},
                          {"mirror": (0.5, -1, 0.5),
                           "scale_xyz": (True, False, True)}],
    "PointCloudScaling_s": [{"scale_s": (0.5, 2.0), "mirror": (0.5, 0.5,
                                                               0.5)}],
    "PointCloudTranslation": [{"shift": (0.5, 0.1, 0.3)}],
    "PointCloudTranslation_s": [{"shift_s": (0.5, 0.1, 0.3)}],
    "PointCloudScaleAndTranslate": [{"anisotropic": False,
                                     "mirror": (0.5, 0.5, -1),
                                     "shift": (0.1, 0.2, 0.3)}],
    "PointCloudScaleAndTranslate_s": [{"scale_s": (0.5, 2.0),
                                       "shift_s": (0.1, 0.2, 0.3),
                                       "scale_xyz": (False, True, True)}],
    "PointCloudJitter": [{"jitter_sigma": 0.2, "jitter_clip": 0.1}],
    "PointCloudJitter_s": [{"jitter_sigma_s": 0.2, "jitter_clip_s": 0.1}],
    "PointCloudRotation": [{"angle": (1, 0.5, 0.25)}],
    "PointCloudRotation_s": [{"angle_s": (1, 1, 1)}],
    "RandomRotate": [{"angle": (0.5, 0.5, 1)}],
    "ChromaticDropGPU": [{"color_drop": 0.9}],
    "ChromaticPerDropGPU": [{"color_drop": 0.5}],
    "RandomDropout": [{"dropout_ratio": 0.4,
                       "dropout_application_ratio": 1.0}],
    "PointCloudScaleAndJitter": [{"anisotropic": False,
                                  "mirror": (0.5, 0.5, 0.5),
                                  "jitter_sigma": 0.2, "jitter_clip": 0.1}],
    "ChromaticNormalize": [{"color_mean": (0.1, 0.2, 0.3),
                            "color_std": (0.5, 0.6, 0.7)}],
    "Cutmix": [],
    "RandomScale": [{"scale": (0.5, 2.0), "anisotropic": True}],
    "RandomShift": [{"shift": ((-1, 1), (0, 0.5), (-0.1, 0.1))}],
    "RandomHorizontalFlip": [{"upright_axis": "x", "aug_prob": 1.0},
                             {"upright_axis": "Y", "aug_prob": 0.5}],
    "RandomRotateZ": [{"angle": 0.5, "rotate_dim": 0},
                      {"angle": 0.25, "rotate_dim": 1,
                       "random_rotate": False}],
    "RandomScaleAndJitter": [{"scale_anisotropic": True,
                              "mirror": (0.5, 0.5, 0.5),
                              "scale_xyz": (True, False, True)}],
    "RandomScaleAndTranslate": [{"scale_xyz": (1, 0, 2),
                                 "shift": (0.3, 0.2, 0.1)}],
    "RandomFlip": [{"p": 0.9}],
    "RandomJitter": [{"jitter_sigma": 0.3, "jitter_clip": 0.2}],
    "ChromaticAutoContrast": [{"p": 1.0}, {"p": 1.0, "blend_factor": 0.3}],
    "ChromaticTranslation": [{"p": 1.0, "ratio": 0.5}],
    "ChromaticJitter": [{"p": 1.0, "std": 0.05}],
    "HueSaturationTranslation": [{"hue_max": 1.0, "saturation_max": 0.9}],
    "RandomDropFeature": [{"feature_drop": 1.0, "drop_dim": (1, 5)}],
    "NumpyChromaticNormalize": [{"color_mean": (0.1, 0.2, 0.3),
                                 "color_std": (0.5, 0.6, 0.7)}],
    "PointCloudXYZAlign": [{"gravity_dim": 0}],
}
CASES = [(name, {}) for name in sorted(jtf.DataTransforms.module_dict)] + [
    (name, kw) for name, kws in sorted(VARIANTS.items()) for kw in kws]
SEEDS = (0, 1, 2, 3, 4, 5)


def item(seed, n=96, grey=False):
    """An item with every entry a transform reads: ``pos`` (float32, or
    float64 for the dtype casts), ``x`` with colours in [0, 255] and two
    more channels, ``normals``, ``colors``, per-point labels ``y`` and a
    scalar ``cls``."""
    rng = np.random.default_rng(100 + seed)
    x = np.concatenate([rng.uniform(0, 255, (n, 3)),
                        rng.standard_normal((n, 2))], axis=1)
    if grey:                      # equal channels: hue and saturation 0
        x[:, 1] = x[:, 2] = x[:, 0]
    nrm = rng.standard_normal((n, 3))
    return {"pos": rng.standard_normal((n, 3)).astype(
                np.float64 if seed % 2 else np.float32),
            "x": x.astype(np.float32),
            "normals": (nrm / np.linalg.norm(nrm, axis=1,
                                             keepdims=True)).astype(
                np.float32),
            "colors": rng.uniform(0, 1, (n, 3)),
            "y": rng.integers(0, 5, n),
            "cls": np.asarray([seed], dtype=np.int64)}


def test_the_registries_hold_the_same_names():
    assert set(ttf.TRANSFORMS) == set(jtf.DataTransforms.module_dict)
    # the registry name of every class the port defines
    for name, cls in ttf.TRANSFORMS.items():
        assert cls.__name__ == name


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_each_transform_is_bit_equal_and_draws_alike(name, kw):
    want_t = jtf.DataTransforms.build({"NAME": name, **kw})
    got_t = ttf.TRANSFORMS[name](**kw)
    for seed in SEEDS:
        for grey in (False, True):
            data = item(seed, grey=grey)
            a, b = copy.deepcopy(data), copy.deepcopy(data)
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = got_t(a, ra), want_t(b, rb)
            assert_items_equal(got, want)
            assert ra.bit_generator.state == rb.bit_generator.state


def test_hsv_round_trip_equals_geot_tpus():
    rng = np.random.default_rng(7)
    rgb = np.concatenate([rng.uniform(0, 255, (500, 3)),
                          np.full((20, 3), 17.0),       # grey: s = 0
                          [[255, 0, 0], [0, 255, 0], [0, 0, 255],
                           [255, 255, 0], [0, 0, 0]]])
    hsv = ttf._rgb_to_hsv(rgb)
    np.testing.assert_array_equal(hsv, jtf._rgb_to_hsv(rgb))
    np.testing.assert_array_equal(ttf._hsv_to_rgb(hsv),
                                  jtf._hsv_to_rgb(hsv))
    np.testing.assert_array_equal(ttf._rodrigues_ref(np.array([1.0, 2, 3]),
                                                     0.7),
                                  jtf._rodrigues_ref(np.array([1.0, 2, 3]),
                                                     0.7))


def test_compose_list_compose_and_the_unknown_name():
    def swap(c, f, lab):
        return f, c, lab + 1

    args = (np.arange(3.0), np.ones(3), np.zeros(3))
    for x, y in zip(ttf.ListCompose([swap, swap, swap])(*args),
                    jtf.ListCompose([swap, swap, swap])(*args)):
        np.testing.assert_array_equal(x, y)
    cfg = {"train": ["PointsToTensor", "PointCloudScaleAndJitter",
                     "RandomDropout", "HueSaturationTranslation"],
           "kwargs": {"dropout_application_ratio": 1.0, "mirror": (0.5,) * 3}}
    got = ttf.build_transforms_from_cfg("train", cfg)
    want = jtf.build_transforms_from_cfg("train", cfg)
    assert_items_equal(got(item(1), np.random.default_rng(3)),
                       want(item(1), np.random.default_rng(3)))
    for split in ("val", "test"):
        assert ttf.build_transforms_from_cfg(split, cfg) is None
        assert jtf.build_transforms_from_cfg(split, cfg) is None
    bad = {"train": ["PointsToTensor", "NoSuchTransform"]}
    for build in (ttf.build_transforms_from_cfg,
                  jtf.build_transforms_from_cfg):
        with pytest.raises(KeyError, match="NoSuchTransform"):
            build("train", bad)


def _batch(seed, B=5, N=64):
    rng = np.random.default_rng(seed)
    return {"pos": rng.standard_normal((B, N, 3)).astype(np.float32),
            "y": rng.integers(0, 50, (B, N)),
            "cls": rng.integers(0, 16, (B, 1))}


@pytest.mark.parametrize("prob,num_mix", [(1.0, 1), (0.5, 3), (1.0, 2)])
def test_cutmix_mix_batch_is_bit_equal_in_place(prob, num_mix):
    got_t, want_t = (ttf.Cutmix(prob=prob, num_mix=num_mix),
                     jtf.Cutmix(prob=prob, num_mix=num_mix))
    mixed = 0
    for seed in range(8):
        a, b = _batch(seed), _batch(seed)
        pos_a = a["pos"]
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = got_t.mix_batch(a, ra), want_t.mix_batch(b, rb)
        assert got["pos"] is pos_a           # mixed in place
        assert_items_equal(got, want)
        assert ra.bit_generator.state == rb.bit_generator.state
        mixed += not np.array_equal(got["y"], _batch(seed)["y"])
        # one item passes through untouched
        one = item(seed)
        assert got_t(one, ra) is one
    assert mixed > 0


MIX_CFG = {"train": ["PointsToTensor", "Cutmix", "PointCloudScaleAndJitter",
                     "RandomDropout"],
           "val": ["PointsToTensor"],
           "kwargs": {"prob": 0.7, "num_mix": 2,
                      "dropout_application_ratio": 0.5}}
MIX_DATASETS = {
    "ShapeNetPartNormal": {"common": {"NAME": "ShapeNetPartNormal",
                                      "num_points": 96}},
    "ShapeNetPart": {"common": {"NAME": "ShapeNetPart", "num_points": 128}},
}


@pytest.mark.parametrize("name", sorted(MIX_DATASETS))
def test_loader_mixes_batches_like_geot_tpu_with_any_worker_count(name):
    ds = MIX_DATASETS[name]
    want = jbuild.build_dataloader_from_cfg(
        4, ds, datatransforms_cfg=MIX_CFG, split="train", seed=3)
    assert len(want.batch_mixers) == 1
    want.set_epoch(2)
    ref = list(want)
    plain = jbuild.build_dataloader_from_cfg(
        4, ds, datatransforms_cfg=dict(MIX_CFG, kwargs=dict(
            MIX_CFG["kwargs"], prob=0.0)), split="train", seed=3)
    plain.set_epoch(2)
    assert any(not np.array_equal(a["y"], b["y"])
               for a, b in zip(ref, plain))
    for w in (1, 4):
        got = tbuild.build_dataloader_from_cfg(
            4, ds, MIX_CFG, split="train", seed=3,
            dataloader_cfg={"num_workers": w})
        assert [type(m).__name__ for m in got.batch_mixers] == ["Cutmix"]
        got.set_epoch(2)
        assert_batches_equal(list(got), ref)
    # no mixer on a split without Cutmix
    assert tbuild.build_dataloader_from_cfg(
        4, ds, MIX_CFG, split="test").batch_mixers == []
