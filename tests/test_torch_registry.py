"""The registries against ``geot_tpu``'s: ``Registry`` and
``build_from_cfg`` case by case (each case runs on both classes and the
outcomes, values or errors, must be equal), the four registries name for
name, and ``build_model_from_cfg(cfg, **default_args)`` building the
modules that ``geot_tpu``'s builds (the same variables, by the
converter's names, load strictly)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geot_tpu.core import registry as jreg
from geot_tpu.data.build import DATASETS as JDATASETS
from geot_tpu.data.transforms import DataTransforms as JTRANSFORMS
from geot_tpu.losses import LOSS as JLOSS
from geot_tpu.models import MODELS as JMODELS
from geot_tpu.models import build_model_from_cfg as jbuild_model

from geot_tpu_torch.core import registry as treg
from geot_tpu_torch.core.config import MODELS as CONFIG_MODELS
from geot_tpu_torch.data import DATASETS, DataTransforms
from geot_tpu_torch.data.transforms import TRANSFORMS
from geot_tpu_torch.engine.convert import params_from_jax, t_params_from_jax
from geot_tpu_torch.losses import LOSS, LOSSES
from geot_tpu_torch.models import MODELS, build_model_from_cfg

from test_torch_model import N_POINTS, SMALL_ARGS


class Point:
    def __init__(self, x=0, y=0, **extra):
        if x == "bad":
            raise ValueError("x must be a number")
        self.x, self.y, self.extra = x, y, extra

    def __eq__(self, other):
        return isinstance(other, Point) and vars(self) == vars(other)


def _outcome(fn):
    """What ``fn()`` returns, or the type and message of what it raises."""
    try:
        out = fn()
    except Exception as e:  # the error is the outcome compared
        return ("raises", type(e), str(e))
    if isinstance(out, (treg.Registry, jreg.Registry)):
        return ("registry", out.name, sorted(out.module_dict))
    return ("returns", out)


def _reg(mod):
    reg = mod.Registry("points")
    reg.register_module()(Point)
    reg.register_module(name="P2", module=Point)

    @reg.register_module(name="origin")
    def origin(**kw):
        return Point(0, 0, **kw)

    return reg


CASES = {
    "build": lambda m, r: r.build({"NAME": "Point", "x": 1}),
    "cfg_over_defaults": lambda m, r: r.build({"NAME": "P2", "x": 1}, x=5,
                                              y=7),
    "name_in_defaults": lambda m, r: r.build({"x": 2}, NAME="Point"),
    "name_callable": lambda m, r: r.build({"NAME": Point, "y": 3}),
    "function_module": lambda m, r: r.build({"NAME": "origin", "z": 1}),
    "no_name": lambda m, r: r.build({"x": 1}),
    "unknown_name": lambda m, r: r.build({"NAME": "Line"}),
    "bad_name_type": lambda m, r: r.build({"NAME": 3}),
    "not_a_mapping": lambda m, r: m.build_from_cfg([("NAME", "Point")], r),
    "failing_class": lambda m, r: r.build({"NAME": "Point", "x": "bad"}),
    "bad_argument": lambda m, r: r.build({"NAME": "origin", "x": 1}),
    "build_from_cfg": lambda m, r: m.build_from_cfg({"NAME": "Point"}, r,
                                                    {"y": 2}),
    "duplicate": lambda m, r: r.register_module()(Point),
    "duplicate_call": lambda m, r: r.register_module(name="P2",
                                                     module=Point),
    "force": lambda m, r: (r.register_module(name="P2", force=True,
                                             module=dict), r.get("P2"))[1],
    "get_unknown": lambda m, r: r.get("Line"),
    "contains": lambda m, r: ("Point" in r, "Line" in r, "origin" in r),
    "len": lambda m, r: len(r),
    "module_dict": lambda m, r: sorted(r.module_dict),
    "name": lambda m, r: r.name,
    "repr": lambda m, r: repr(r),
    "custom_build_func": lambda m, r: m.Registry(
        "x", build_func=lambda cfg, reg, d: (cfg["NAME"], d)).build(
        {"NAME": "a"}, k=1),
    "default_args_not_mutated": lambda m, r: (lambda d: (r.build(
        {"NAME": "Point"}, **d), d))({"x": 4}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_registry_behaves_as_geot_tpus(case):
    outcomes = [_outcome(lambda: CASES[case](m, _reg(m)))
                for m in (jreg, treg)]
    assert outcomes[1] == outcomes[0]


def test_registry_reads_as_a_dict():
    """The port's only addition: the lookups of the dicts it replaced."""
    reg = _reg(treg)
    assert reg["P2"] is Point
    with pytest.raises(KeyError):
        reg["Line"]
    assert list(reg) == list(reg.keys()) == ["Point", "P2", "origin"]
    assert dict(reg.items()) == reg.module_dict
    assert list(reg.values())[0] is Point
    assert sorted(reg) == sorted(_reg(jreg).module_dict)


@pytest.mark.parametrize("port,ref", [
    (MODELS, JMODELS), (LOSS, JLOSS), (DATASETS, JDATASETS),
    (DataTransforms, JTRANSFORMS)], ids=["MODELS", "LOSS", "DATASETS",
                                        "DataTransforms"])
def test_registries_hold_geot_tpus_names(port, ref):
    assert isinstance(port, treg.Registry)
    assert set(port.module_dict) == set(ref.module_dict)
    assert len(port) == len(ref)
    assert port.name == ref.name


def test_the_ports_names_are_the_same_registries():
    assert CONFIG_MODELS is MODELS and LOSSES is LOSS
    assert TRANSFORMS is DataTransforms
    assert len(MODELS) == 43 and len(DataTransforms) == 35
    assert "TeethSegSemiLDataset" in DATASETS
    assert MODELS["WholePartSeg"] is MODELS.get("WholePartSeg")


def _jax_variables(cfg, *args, **default_args):
    """``geot_tpu``'s module of ``cfg`` with ``default_args``, its
    variables as numpy zeros of their shapes (traced, not computed)."""
    module = jbuild_model(dict(cfg), **default_args)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(1)}, *args))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def test_build_model_from_cfg_takes_default_args():
    """The flagship composition from a cfg that names only the class, its
    segmentor's arguments as ``default_args``; ``cfg`` wins over
    ``default_args``."""
    pos = jnp.zeros((1, N_POINTS, 3))
    batch = {"pos": pos, "x": pos, "cls": jnp.zeros((1, 1), jnp.int32)}
    variables = _jax_variables({"NAME": "WholePartSeg"}, batch,
                               segmentor_args=SMALL_ARGS)
    model = build_model_from_cfg({"NAME": "WholePartSeg"},
                                 segmentor_args=SMALL_ARGS)
    model.load_state_dict(params_from_jax(variables), strict=True)
    assert len(model.segmentor.blocks.blocks) == SMALL_ARGS["depth"]

    probs = jnp.ones((1, 8, 5)) / 5
    t_cfg = {"NAME": "Ins_T_mean",
             "T_args": {"NAME": "sig_t_mean", "nclasses": 5}}
    nine = {"T_args": {"NAME": "sig_t_mean", "nclasses": 9}}
    t_vars = _jax_variables(t_cfg, probs, jnp.eye(5), **nine)
    t_model = build_model_from_cfg(t_cfg, **nine)
    want = t_params_from_jax(t_vars["params"])
    got = t_model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()} == \
        {"T_predictor.fc": (5, 10, 5)}


def test_a_module_registered_by_the_decorator_builds_as_in_geot_tpu():
    """``@MODELS.register_module(name=...)`` in both packages; the cfg
    overrides ``default_args``, ``NAME`` is not passed on, and a failing
    construction names the class."""
    name = "_RegistryTestHead"

    def make(registry, base):
        @registry.register_module(name=name)
        class Head(base):
            def __init__(self, width=4, depth=1, **kw):
                if depth < 1:
                    raise ValueError("depth must be >= 1")
                super().__init__()
                self.width, self.depth, self.kw = width, depth, kw

        return Head

    try:
        make(JMODELS, object)
        make(MODELS, torch.nn.Module)
        for cfg, defaults in (({"NAME": name, "width": 8}, {"width": 2,
                                                            "depth": 3}),
                              ({"NAME": name}, {"extra": "x"})):
            j = jbuild_model(dict(cfg), **defaults)
            t = build_model_from_cfg(dict(cfg), **defaults)
            assert (t.width, t.depth, t.kw) == (j.width, j.depth, j.kw)
        outcomes = [_outcome(lambda: b({"NAME": name, "depth": 0}))
                    for b in (jbuild_model, build_model_from_cfg)]
        assert outcomes[1] == outcomes[0]
        assert outcomes[0][2] == "Head: depth must be >= 1"
        assert isinstance(MODELS[name](), torch.nn.Module)
    finally:
        JMODELS.module_dict.pop(name, None)
        MODELS.module_dict.pop(name, None)
