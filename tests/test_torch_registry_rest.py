"""The rest of GeoT's model registry against ``geot_tpu``, module by
module: the seg variants (``PointTransformer_seg_cluster``,
``_classifier`` and ``_2classifier``) under ``WholePartSeg_ntm``, exact
and in the serving order; the cls-token encoders
(``PointTransformerGenEncoder``, ``PointTransformerEncoder``) with ball
query and kNN groups; ``sig_t`` and ``Ins_T``; ``MultiSegHead``'s padded
stack; ``VariableSeg`` with ``VariableSegHead``; ``DistillBaseSeg``;
``PointPatchEmbed`` and ``P3Embed``; the tokenizers; ``Gragh_Matching``,
which raises in both; the two registries name for name; and the
converter, which names a leaf it cannot place.

Inputs from a numpy seed at a small size (2 clouds of 128 points, width
48, 2-3 blocks), weights drawn by numpy into ``geot_tpu``'s tree
(``jax.eval_shape`` of its init: no compile) and carried across by
``params_from_jax``; the eval forward within ``EVAL_RTOL`` of the largest
output, as ``tests/test_torch_heritage_models.py``. At 128 points every
JAX neighbour search is exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.models import MODELS as JMODELS
from geot_tpu.models import build_model_from_cfg as jbuild
from geot_tpu.models.layers.group_embed import (
    GroupTokenizer as JGroupTokenizer, SubsampleGroup as JSubsampleGroup)

from geot_tpu_torch.core.config import MODELS, build_model_from_cfg
from geot_tpu_torch.engine.convert import params_from_jax, t_params_from_jax
from geot_tpu_torch.models.layers.group_embed import (GroupTokenizer,
                                                      SubsampleGroup)

B, N = 2, 128
EVAL_RTOL = 1e-4
SEG = {"trans_dim": 48, "depth": 3, "num_heads": 4, "group_size": 8,
       "num_group": 16, "encoder_dims": 32, "nclasses": 17,
       "drop_path_rate": 0.0, "downsample_targets": [64, 32, 16],
       "extract_layers": [1, 2, 3]}
VARIANTS = ("PointTransformer_seg_cluster", "PointTransformer_seg_classifier",
            "PointTransformer_seg_2classifier")
FEAT_WIDTH = {"PointTransformer_seg_cluster": 64,
              "PointTransformer_seg_classifier": 128,
              "PointTransformer_seg_2classifier": 48}
ENC = {"NAME": "PointNet2Encoder", "in_channels": 3, "width": 8,
       "layers": 2, "strides": [4, 4], "radius": 0.2, "num_samples": 8,
       "blocks": [1, 1], "aggr_args": {"feature_type": "dp_fj"}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(17)
    pos = rng.uniform(-1.0, 1.0, (B, N, 3)).astype(np.float32)
    x = rng.standard_normal((B, N, 3)).astype(np.float32)
    return pos, x


def draw_variables(jmodel, *args, seed=3, **kwargs):
    """Variables of ``jmodel``'s tree drawn by numpy: kernels N(0, 1 /
    fan_in), biases, BatchNorm shifts and raw parameters N(0, 0.1^2)
    (``sig_t``'s ``fc`` 0.1 / C + U(0, 0.02)), scales 1 + U(-0.1, 0.1),
    running means U(-0.05, 0.05) and variances U(0.8, 1.2)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + rng.uniform(-0.1, 0.1, shape)
        elif name == "mean":
            a = rng.uniform(-0.05, 0.05, shape)
        elif name == "var":
            a = rng.uniform(0.8, 1.2, shape)
        elif name == "fc":
            a = 0.1 / shape[-1] + rng.uniform(0.0, 0.02, shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel(got, want):
    if torch.is_tensor(got):
        got = got.detach()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def port(cfg, variables, converter=params_from_jax):
    model = build_model_from_cfg(cfg)
    model.load_state_dict(converter(variables), strict=True)
    return model.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- the seg variants --------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_pyramid"])
@pytest.mark.parametrize("name", VARIANTS)
def test_seg_variant_matches_geot_tpu(clouds, name, fast):
    """``WholePartSeg_ntm`` over the variant: the logits and the fourth
    output (the 64-d projection, the 128-d prototype features, ``f_l0``)
    within ``EVAL_RTOL``; no correction and no ``sigma``. In the serving
    order the projection follows the logits through the un-permute."""
    pos, _ = clouds
    seg = dict(SEG, NAME=name, fast_pyramid=fast)
    cfg = {"NAME": "WholePartSeg_ntm", "segmentor_args": seg}
    batch = {"pos": pos, "x": pos, "cls": np.array([[0], [1]], np.int32)}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, _j(batch))
    jl, jc, js, jf = jmodel.apply(_j(variables), _j(batch))
    assert jc is None and js is None
    model = port(cfg, variables)
    with torch.no_grad():
        tl, tc, ts, tf = model({k: _t(v).long() if k == "cls" else _t(v)
                                for k, v in batch.items()})
    assert tc is None and ts is None
    assert tf.shape == (B, N, FEAT_WIDTH[name])
    rl, rf = _rel(tl, jl), _rel(tf, jf)
    print(f"{name} fast={fast}: logits {rl:.2e}, features {rf:.2e}")
    assert rl <= EVAL_RTOL and rf <= EVAL_RTOL


def test_whole_part_seg_ntm_stacks_the_fixmatch_batches(clouds):
    """With ``u0`` and ``fixmatch`` the labelled, strong and weak batches go
    through one forward, the T thread not at all (``u0["T"]`` is
    ignored); with ``u0`` alone only the labelled batch; ``if_teacher``
    reads the weak view."""
    pos, x = clouds
    cfg = {"NAME": "WholePartSeg_ntm",
           "segmentor_args": dict(SEG, NAME="PointTransformer_seg_T")}
    p0 = {"pos": pos[:1], "x": pos[:1], "cls": np.array([[0]], np.int32)}
    u0 = {"pos_s": pos[1:], "x_s": pos[1:], "cls_s": np.array([[1]]),
          "pos_w": x[:1], "x_w": x[:1], "cls_w": np.array([[0]]),
          "T": np.eye(17, dtype=np.float32)}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, _j(p0))
    model = port(cfg, variables)

    def tt(d):
        return {k: _t(v).long() if k.startswith("cls") else _t(v)
                for k, v in d.items()}

    for kw in ({"u0": u0, "fixmatch": True}, {"u0": u0}, {}):
        want = jmodel.apply(_j(variables), _j(p0),
                            **{k: _j(v) if k == "u0" else v
                               for k, v in kw.items()})
        with torch.no_grad():
            got = model(tt(p0), **{k: tt(v) if k == "u0" else v
                                   for k, v in kw.items()})
        assert got[1] is None and want[1] is None
        assert _rel(got[0], want[0]) <= EVAL_RTOL
        assert _rel(got[2], want[2]) == 0.0          # sigma
        assert got[0].shape[0] == (3 if kw.get("fixmatch") else 1)
    want = jmodel.apply(_j(variables), _j(u0), if_teacher=True)
    with torch.no_grad():
        got = model(tt(u0), if_teacher=True)
    assert _rel(got[0], want[0]) <= EVAL_RTOL


def test_classifier_prototypes_are_detached():
    """The classifier variant's features reach the seg head's last weight
    through the logits only, as under ``geot_tpu``'s ``stop_gradient``:
    the gradient of their sum is that of ``log_softmax(logit) @ s`` with
    ``s`` the fixed column sums of the normalised prototypes."""
    torch.manual_seed(0)
    model = build_model_from_cfg(dict(SEG, NAME="PointTransformer_seg_"
                                      "classifier")).eval()
    pos = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (1, N, 3)).astype(np.float32))
    w = model.seg_head[3].weight
    logit, _, _, feats = model(pos)
    got = torch.autograd.grad(feats.sum(), w, retain_graph=True)[0]
    proto = w.detach().T
    proto = proto / (proto.norm(dim=0, keepdim=True) + 1e-12)
    want = torch.autograd.grad(
        (torch.log_softmax(logit, -1) * proto.sum(0)).sum(), w)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# --- the cls-token encoders ------------------------------------------------

@pytest.mark.parametrize("group", ["ballquery", "knn"])
@pytest.mark.parametrize("name", ["PointTransformerGenEncoder",
                                  "PointTransformerEncoder"])
def test_cls_token_encoder_matches_geot_tpu(clouds, name, group):
    """The tokens without the cls token and the centers, or [cls ; max]
    (B, 2 D), within ``EVAL_RTOL``; ``forward_cls_feat`` is the forward."""
    pos, _ = clouds
    cfg = {"NAME": name, "num_groups": 16, "group_size": 8,
           "encoder_dims": 32, "trans_dim": 48, "depth": 2, "num_heads": 4,
           "group": group, "radius": 0.4, "drop_path_rate": 0.0}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, jnp.asarray(pos))
    assert variables["params"]["cls_token"].shape == (1, 1, 48)
    want = jmodel.apply(_j(variables), jnp.asarray(pos))
    model = port(cfg, variables)
    with torch.no_grad():
        got = model(_t(pos))
        again = model.forward_cls_feat({"pos": _t(pos)})
    if name == "PointTransformerGenEncoder":
        assert got[0].shape == (B, 16, 48) and got[1].shape == (B, 16, 3)
        assert _rel(got[0], want[0]) <= EVAL_RTOL
        assert _rel(got[1], want[1]) == 0.0
        torch.testing.assert_close(again[0], got[0], rtol=0, atol=0)
    else:
        assert got.shape == (B, 96) and model.out_channels == 96
        assert _rel(got, want) <= EVAL_RTOL
        torch.testing.assert_close(again, got, rtol=0, atol=0)


# --- sig_t, Ins_T, the heads and compositions ------------------------------

def test_sig_t_and_ins_t_match_geot_tpu():
    """``sig_t`` standalone and as ``Ins_T``'s predictor: (B N, C, C) rows
    summing to 1, within ``EVAL_RTOL``; the port's own init is 0.1 / C."""
    rng = np.random.default_rng(5)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((2, 16, 17)).astype(np.float32)), -1))
    cfg = {"NAME": "sig_t", "nclasses": 17}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, jnp.asarray(probs))
    want = jmodel.apply(_j(variables), jnp.asarray(probs))
    with torch.no_grad():
        got = port(cfg, variables)(_t(probs))
    assert got.shape == (32, 17, 17)
    assert _rel(got, want) <= EVAL_RTOL
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)
    assert torch.all(build_model_from_cfg(cfg).fc == 0.1 / 17)

    icfg = {"NAME": "Ins_T", "T_args": cfg}
    jins = jbuild(icfg)
    ivars = draw_variables(jins, jnp.asarray(probs))
    want = jins.apply(_j(ivars), jnp.asarray(probs))
    with torch.no_grad():
        got = port(icfg, ivars["params"], t_params_from_jax)(_t(probs))
    assert _rel(got, want) <= EVAL_RTOL


def test_multi_seg_head_pads_and_stacks(clouds):
    """Per-category heads padded with -1e9 to the largest part count and
    stacked (S, B, N, P), within ``EVAL_RTOL`` on the real entries and
    equal on the padding."""
    rng = np.random.default_rng(6)
    f = rng.standard_normal((B, N, 16)).astype(np.float32)
    cfg = {"NAME": "MultiSegHead", "in_channels": 16, "shape_classes": 4,
           "num_parts": [2, 3, 4, 2]}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, jnp.asarray(f))
    want = np.asarray(jmodel.apply(_j(variables), jnp.asarray(f)))
    with torch.no_grad():
        got = port(cfg, variables)(_t(f)).numpy()
    assert got.shape == want.shape == (4, B, N, 4)
    real = want > -1e8
    assert np.array_equal(got > -1e8, real)
    assert np.array_equal(got[~real], want[~real])
    assert np.abs(got[real] - want[real]).max() <= \
        EVAL_RTOL * np.abs(want[real]).max()


@pytest.mark.parametrize("name", ["VariableSeg", "DistillBaseSeg"])
def test_variable_and_distill_base_seg_match_geot_tpu(clouds, name):
    """``BaseSeg`` as ``inner`` with ``VariableSegHead`` (its
    ``in_channels`` the hidden width, here not the decoder's): the logits
    within ``EVAL_RTOL``, from a dict and from arrays alike."""
    pos, x = clouds
    cfg = {"NAME": name, "encoder_args": ENC,
           "decoder_args": {"NAME": "PointNet2Decoder"},
           "cls_args": {"NAME": "VariableSegHead", "num_classes": 17,
                        "in_channels": 24, "dropout_ratio": 0.0}}
    if name == "DistillBaseSeg":
        cfg.update(distill_args={"ignored": True}, criterion_args=None)
    batch = {"pos": pos, "x": x}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, _j(batch))
    assert variables["params"]["inner"]["head"]["fc0"]["kernel"].shape[-1] \
        == 24
    want = jmodel.apply(_j(variables), _j(batch))
    model = port(cfg, variables)
    with torch.no_grad():
        got = model({k: _t(v) for k, v in batch.items()})
        again = model(_t(pos), _t(x))
    assert got.shape == (B, N, 17)
    assert _rel(got, want) <= EVAL_RTOL
    torch.testing.assert_close(again, got, rtol=0, atol=0)


# --- patch embeddings and tokenizers ----------------------------------------

@pytest.mark.parametrize("with_x", [False, True], ids=["pos", "pos_x"])
def test_point_patch_embed_matches_geot_tpu(clouds, with_x):
    pos, x = clouds
    cfg = {"NAME": "PointPatchEmbed", "sample_ratio": 0.25,
           "group_size": 8, "channels": [16, 32]}
    args = (jnp.asarray(pos),) + ((jnp.asarray(x),) if with_x else ())
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, *args)
    want = jmodel.apply(_j(variables), *args)
    model = port(dict(cfg, in_channels=3 if with_x else 0), variables)
    with torch.no_grad():
        got = model(_t(pos), _t(x) if with_x else None)
    assert got[0].shape == (B, 32, 32) and got[1].shape == (B, 32, 3)
    assert _rel(got[0], want[0]) <= EVAL_RTOL
    assert _rel(got[1], want[1]) == 0.0
    with pytest.raises(ValueError, match="in_channels"):
        model(_t(pos), None if with_x else _t(x))


@pytest.mark.parametrize("with_x", [False, True], ids=["pos", "pos_x"])
def test_p3embed_matches_geot_tpu(clouds, with_x):
    pos, x = clouds
    cfg = {"NAME": "P3Embed", "stages": 2, "sample_ratio": 0.5,
           "group_size": 8, "channels": [8, 16]}
    batch = {"pos": pos, "x": x} if with_x else {"pos": pos}
    jmodel = jbuild(cfg)
    variables = draw_variables(jmodel, _j(batch))
    assert set(variables["params"]) == {"stage_0", "stage_1"}
    want = jmodel.apply(_j(variables), _j(batch))
    with torch.no_grad():
        got = port(cfg, variables)({k: _t(v) for k, v in batch.items()})
    assert got[0].shape == (B, 32, 16) and got[1].shape == (B, 32, 3)
    assert _rel(got[0], want[0]) <= EVAL_RTOL
    assert _rel(got[1], want[1]) == 0.0


def test_tokenizers_match_geot_tpu(clouds):
    """``GroupTokenizer`` (the flagship's, the genencoder's) and
    ``SubsampleGroup`` with ball query (positions, then features) and
    kNN: bit-equal indices and centers."""
    pos, x = clouds
    jn, jc, ji = JGroupTokenizer(16, 8)(jnp.asarray(pos))
    tn, tc, ti = GroupTokenizer(16, 8)(_t(pos))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                               atol=1e-7)
    for group in ("ballquery", "knn"):
        j = JSubsampleGroup(16, 8, group=group, radius=0.4)(
            jnp.asarray(pos), jnp.asarray(x))
        t = SubsampleGroup(16, 8, group=group, radius=0.4)(_t(pos), _t(x))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)


# --- the registry and the converter ----------------------------------------

def test_port_registers_every_geot_tpu_model_name():
    names = set(getattr(JMODELS, "_module_dict", JMODELS))
    assert names == set(MODELS), sorted(names ^ set(MODELS))
    assert len(MODELS) == 43


def test_gragh_matching_raises_in_both():
    jmodel = jbuild({"NAME": "Gragh_Matching", "in_channels": 8})
    with pytest.raises(NotImplementedError, match="stub"):
        jmodel(None, None, None)
    model = build_model_from_cfg({"NAME": "Gragh_Matching",
                                  "in_channels": 8})
    assert model.in_channels == 8 and model.sample_nums == 1024
    with pytest.raises(NotImplementedError, match="stub"):
        model(None, None, None)


def test_converter_names_a_leaf_it_cannot_place():
    """A layer with a foreign leaf, an unknown raw parameter, running
    statistics without their norm and a T-predictor's stray leaf each
    raise, naming the leaf; nothing is dropped silently."""
    k = np.zeros((4, 4), np.float32)
    bad = (
        ({"params": {"head": {"out": {"kernel": k, "gamma": k}}}},
         "head/out/gamma"),
        ({"params": {"head": {"token": k}}}, "head/token"),
        ({"params": {"segmentor": {"T_linear": k, "T_extra": k}}},
         "segmentor/T_extra"),
        ({"params": {"head": {"out": {"kernel": k}}},
          "batch_stats": {"head": {"bn": {"mean": k[0], "var": k[0]}}}},
         "batch_stats/head/bn"),
    )
    for variables, leaf in bad:
        with pytest.raises(ValueError, match=leaf):
            params_from_jax(variables)
    with pytest.raises(ValueError, match="T_predictor/bias"):
        t_params_from_jax({"T_predictor": {"fc": k, "bias": k[0]}})


@pytest.mark.parametrize("name", VARIANTS)
def test_seg_variant_checkpoint_serves(tmp_path, name):
    """``load_model`` reads a ``WholePartSeg_ntm`` state_dict file of each
    variant (through ``read_weights``' seg_T conversion, which keeps the
    cluster variant's projection) and ``predict_scan`` labels a scan with
    its logits, as the model itself gives them."""
    from geot_tpu_torch.engine.predict import load_model, predict_scan
    from geot_tpu_torch.models.segmentation.base_seg import init_weights

    cfg = {"NAME": "WholePartSeg_ntm",
           "segmentor_args": dict(SEG, NAME=name)}
    model = init_weights(build_model_from_cfg(cfg),
                         torch.Generator().manual_seed(4)).eval()
    path = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), path)
    served = load_model(model_cfg=cfg, ckpt=path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k
    pts = np.random.default_rng(9).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    labels, logits = predict_scan(served, pts, 1, num_points=N)
    assert labels.shape == (300,) and logits.shape == (N, 17)
    assert torch.isfinite(logits).all()
