"""Host-side augmentations of the flagship recipe
(``geot_tpu/data/transforms.py``): numpy callables taking ``(data dict,
np.random.Generator)``, drawing from the dataset's generator in the same
order as ``geot_tpu``'s, so batches are bit-equal. Every ``*_s`` variant
reads its strength from the ``*_s`` keys of ``datatransforms.kwargs``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class Compose:
    """``geot_tpu/data/transforms.py:19``."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data, rng):
        for t in self.transforms:
            data = t(data, rng)
        return data


class PointsToTensor:
    """float64 arrays -> float32 (``:56``)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data, rng):
        for k, v in data.items():
            if isinstance(v, np.ndarray) and v.dtype == np.float64:
                data[k] = v.astype(np.float32)
        return data


class PointCloudCenterAndNormalize:
    """Centering, unit sphere and the ``heights`` channel along
    ``gravity_dim`` (``:71``, with its defaults)."""

    def __init__(self, gravity_dim=2, **kwargs):
        self.gravity_dim = gravity_dim

    def __call__(self, data, rng):
        pos = data["pos"]
        h = pos[:, self.gravity_dim:self.gravity_dim + 1]
        data["heights"] = h - h.min()
        pos = pos - pos.mean(axis=0, keepdims=True)
        m = np.sqrt((pos ** 2).sum(-1, keepdims=True)).max()
        data["pos"] = pos / m
        return data


class _Scaling:
    """Anisotropic scaling by ``uniform(*scale)`` per axis (``geot_tpu``'s
    defaults: every axis, no mirroring)."""

    def __init__(self, scale):
        self.scale_min, self.scale_max = float(scale[0]), float(scale[1])

    def __call__(self, data, rng):
        scale = rng.uniform(self.scale_min, self.scale_max, 3).astype(
            np.float32)
        data["pos"] = data["pos"] * scale
        return data


class PointCloudScaling(_Scaling):
    """``:121``."""

    def __init__(self, scale=(2 / 3, 3 / 2), **kwargs):
        super().__init__(scale)


class PointCloudScaling_s(_Scaling):
    """Strong-view scaling, keyed by ``scale_s`` (``:130``)."""

    def __init__(self, scale_s=(2 / 3, 3 / 2), **kwargs):
        super().__init__(scale_s)


class PointCloudTranslation_s:
    """Strong-view translation by ``uniform(0, 1) * shift_s`` (``:158``)."""

    def __init__(self, shift_s=(0.2, 0.2, 0.0), **kwargs):
        self.shift = np.asarray(shift_s, dtype=np.float32)

    def __call__(self, data, rng):
        t = rng.uniform(0, 1, 3).astype(np.float32) * self.shift
        data["pos"] = data["pos"] + t
        return data


def _axis_rotation(axis_ind: int, theta: float) -> np.ndarray:
    """Rotation about one coordinate axis
    (``transforms.py:_axis_rotation``)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis_ind]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s if axis_ind != 1 else s
    m[j, i] = s if axis_ind != 1 else -s
    return m


class PointCloudRotation_s:
    """Strong-view rotation: one angle per axis in ``±angle_s * pi``, the
    three axis rotations in shuffled order (``:246``)."""

    def __init__(self, angle_s=(0, 0, 0), **kwargs):
        self.angle = np.asarray(angle_s, dtype=np.float64) * np.pi

    def __call__(self, data, rng):
        mats = [_axis_rotation(axis_ind, rng.uniform(-bound, bound))
                for axis_ind, bound in enumerate(self.angle)]
        rng.shuffle(mats)
        rot = (mats[0] @ mats[1] @ mats[2]).astype(np.float32)
        data["pos"] = data["pos"] @ rot.T
        return data


TRANSFORMS = {cls.__name__: cls for cls in (
    PointsToTensor, PointCloudCenterAndNormalize, PointCloudScaling,
    PointCloudScaling_s, PointCloudTranslation_s, PointCloudRotation_s)}


def build_transforms_from_cfg(split: str, datatransforms_cfg: Optional[
        Dict[str, Any]]) -> Optional[Compose]:
    """The transform list of ``split`` built with the shared ``kwargs``
    (``geot_tpu/data/transforms.py:build_transforms_from_cfg``)."""
    cfg = dict(datatransforms_cfg or {})
    names = cfg.get(split)
    if not names:
        return None
    kwargs = dict(cfg.get("kwargs", {}))
    unknown = [n for n in names if n not in TRANSFORMS]
    if unknown:
        raise KeyError(f"transforms not ported: {unknown}; ported: "
                       f"{sorted(TRANSFORMS)}")
    return Compose([TRANSFORMS[n](**kwargs) for n in names])
