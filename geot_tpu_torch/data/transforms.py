"""Host-side augmentations (``geot_tpu/data/transforms.py``): numpy
callables taking ``(data dict, np.random.Generator)`` that draw from the
dataset's generator in the same order as ``geot_tpu``'s, so an item, and
the generator's state after it, are bit-equal. ``TRANSFORMS`` holds every
name of ``geot_tpu``'s ``DataTransforms`` registry. Every ``*_s`` variant
reads its strength from the ``*_s`` keys of ``datatransforms.kwargs``.

``Cutmix`` does nothing to one item: the loader applies its
``mix_batch`` to each collated batch (``data/build.py``).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np

from ..core.registry import Registry


class Compose:
    """``:19``."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data, rng=None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            data = t(data, rng)
        return data


class ListCompose:
    """Chains transforms over ``(coord, feat, label)`` triples (``:30``)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, coord, feat, label):
        for t in self.transforms:
            coord, feat, label = t(coord, feat, label)
        return coord, feat, label


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
    ``gravity_dim`` (or ``pos`` above its minimum with ``append_xyz``)
    (``:71``)."""

    def __init__(self, centering=True, normalize=True, gravity_dim=2,
                 append_xyz=False, **kwargs):
        self.centering = centering
        self.normalize = normalize
        self.gravity_dim = gravity_dim
        self.append_xyz = append_xyz

    def __call__(self, data, rng):
        pos = data["pos"]
        if self.append_xyz:
            data["heights"] = pos - pos.min()
        else:
            h = pos[:, self.gravity_dim:self.gravity_dim + 1]
            data["heights"] = h - h.min()
        if self.centering:
            pos = pos - pos.mean(axis=0, keepdims=True)
        if self.normalize:
            m = np.sqrt((pos ** 2).sum(-1, keepdims=True)).max()
            pos = pos / m
        data["pos"] = pos
        return data


class _Scaling:
    """Scaling by ``uniform(*scale)``, per axis when ``anisotropic``, axes
    off in ``scale_xyz`` left alone, each axis mirrored where a uniform
    draw passes its ``mirror`` threshold (``:98``)."""

    def __init__(self, scale, anisotropic=True, scale_xyz=(True, True, True),
                 mirror=(0, 0, 0)):
        self.scale_min, self.scale_max = float(scale[0]), float(scale[1])
        self.anisotropic = anisotropic
        self.scale_xyz = scale_xyz
        self.mirror = np.asarray(mirror)

    def __call__(self, data, rng):
        n = 3 if self.anisotropic else 1
        scale = rng.uniform(self.scale_min, self.scale_max, n).astype(
            np.float32)
        if (self.mirror > 0).any():
            mirror = (rng.uniform(size=3) > self.mirror).astype(
                np.float32) * 2 - 1
            scale = scale * mirror
        if self.anisotropic:
            for i, s in enumerate(self.scale_xyz):
                if not s:
                    scale[i] = 1.0
        data["pos"] = data["pos"] * scale
        return data


class PointCloudScaling(_Scaling):
    """``:121``."""

    def __init__(self, scale=(2 / 3, 3 / 2), anisotropic=True,
                 scale_xyz=(True, True, True), mirror=(0, 0, 0), **kwargs):
        super().__init__(scale, anisotropic, scale_xyz, mirror)


class PointCloudScaling_s(_Scaling):
    """Strong-view scaling, keyed by ``scale_s`` (``:130``)."""

    def __init__(self, scale_s=(2 / 3, 3 / 2), anisotropic=True,
                 scale_xyz=(True, True, True), mirror=(0, 0, 0), **kwargs):
        super().__init__(scale_s, anisotropic, scale_xyz, mirror)


class _Translation:
    """A shift of ``uniform(0, 1) * shift`` per axis (``:139``)."""

    def __init__(self, shift):
        self.shift = np.asarray(shift, dtype=np.float32)

    def __call__(self, data, rng):
        t = rng.uniform(0, 1, 3).astype(np.float32) * self.shift
        data["pos"] = data["pos"] + t
        return data


class PointCloudTranslation(_Translation):
    """``:150``."""

    def __init__(self, shift=(0.2, 0.2, 0.0), **kwargs):
        super().__init__(shift)


class PointCloudTranslation_s(_Translation):
    """Strong-view translation, keyed by ``shift_s`` (``:158``)."""

    def __init__(self, shift_s=(0.2, 0.2, 0.0), **kwargs):
        super().__init__(shift_s)


class PointCloudScaleAndTranslate:
    """``_Scaling``, then a shift uniform in ``[-shift, shift]`` per axis
    (``:166``)."""

    def __init__(self, scale=(2 / 3, 3 / 2), scale_xyz=(True, True, True),
                 anisotropic=True, shift=(0.2, 0.2, 0.2), mirror=(0, 0, 0),
                 **kwargs):
        self.scaler = _Scaling(scale, anisotropic, scale_xyz, mirror)
        self.shift = np.asarray(shift, dtype=np.float32)

    def __call__(self, data, rng):
        data = self.scaler(data, rng)
        t = (rng.uniform(0, 1, 3).astype(np.float32) - 0.5) * 2 * self.shift
        data["pos"] = data["pos"] + t
        return data


class PointCloudScaleAndTranslate_s(PointCloudScaleAndTranslate):
    """Strong-view scale and translate, keyed by ``scale_s`` and
    ``shift_s`` (``:740``)."""

    def __init__(self, scale_s=(2 / 3, 3 / 2), scale_xyz=(True, True, True),
                 anisotropic=True, shift_s=(0.2, 0.2, 0.2), mirror=(0, 0, 0),
                 **kwargs):
        super().__init__(scale_s, scale_xyz, anisotropic, shift_s, mirror)


class _Jitter:
    """Gaussian noise of ``sigma`` on ``pos``, cast to float32 and clipped
    to ``clip`` (``:181``)."""

    def __init__(self, sigma, clip):
        self.sigma, self.clip = sigma, clip

    def __call__(self, data, rng):
        noise = (rng.standard_normal(data["pos"].shape)
                 * self.sigma).astype(np.float32)
        data["pos"] = data["pos"] + np.clip(noise, -self.clip, self.clip)
        return data


class PointCloudJitter(_Jitter):
    """``:192``."""

    def __init__(self, jitter_sigma=0.01, jitter_clip=0.05, **kwargs):
        super().__init__(jitter_sigma, jitter_clip)


class PointCloudJitter_s(_Jitter):
    """Strong-view jitter, keyed by ``jitter_sigma_s`` and
    ``jitter_clip_s`` (``:200``)."""

    def __init__(self, jitter_sigma_s=0.01, jitter_clip_s=0.05, **kwargs):
        super().__init__(jitter_sigma_s, jitter_clip_s)


def _axis_rotation(axis_ind: int, theta: float) -> np.ndarray:
    """Rotation about one coordinate axis (``:207``)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(3, dtype=np.float32)
    i, j = [(1, 2), (0, 2), (0, 1)][axis_ind]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s if axis_ind != 1 else s
    m[j, i] = s if axis_ind != 1 else -s
    return m


class _Rotation:
    """One angle per axis in ``±angle * pi`` (0 for a ``None`` bound), the
    three axis rotations in shuffled order, applied to ``pos`` and
    ``normals`` (``:220``)."""

    def __init__(self, angle):
        self.angle = np.asarray(angle, dtype=np.float64) * np.pi

    def __call__(self, data, rng):
        mats = []
        for axis_ind, bound in enumerate(self.angle):
            theta = rng.uniform(-bound, bound) if bound is not None else 0.0
            mats.append(_axis_rotation(axis_ind, theta))
        rng.shuffle(mats)
        rot = (mats[0] @ mats[1] @ mats[2]).astype(np.float32)
        data["pos"] = data["pos"] @ rot.T
        if "normals" in data:
            data["normals"] = data["normals"] @ rot.T
        return data


class PointCloudRotation(_Rotation):
    """``:238``."""

    def __init__(self, angle=(0, 0, 0), **kwargs):
        super().__init__(angle)


class PointCloudRotation_s(_Rotation):
    """Strong-view rotation, keyed by ``angle_s`` (``:246``)."""

    def __init__(self, angle_s=(0, 0, 0), **kwargs):
        super().__init__(angle_s)


class RandomRotate(_Rotation):
    """``:269``: ``_Rotation`` about z by default."""

    def __init__(self, angle=(0, 0, 1), **kwargs):
        super().__init__(angle)


class ChromaticDropGPU:
    """Zero the first 3 channels of ``x`` with probability ``color_drop``
    (``:254``)."""

    def __init__(self, color_drop=0.2, **kwargs):
        self.color_drop = color_drop

    def __call__(self, data, rng):
        if rng.uniform() < self.color_drop and "x" in data:
            data["x"] = data["x"].copy()
            data["x"][:, :3] = 0
        return data


class ChromaticPerDropGPU:
    """Zero each point's first 3 channels of ``x`` with probability
    ``color_drop`` (``:313``)."""

    def __init__(self, color_drop=0.2, **kwargs):
        self.color_drop = color_drop

    def __call__(self, data, rng):
        if "x" in data:
            keep = (rng.uniform(size=(len(data["x"]), 1)) > self.color_drop)
            data["x"] = data["x"].copy()
            data["x"][:, :3] *= keep.astype(data["x"].dtype)
        return data


class RandomDropout:
    """With probability ``dropout_application_ratio``, keep a random
    ``1 - dropout_ratio`` of the points and refill the cloud to N with
    repeats drawn from the kept ones; every array of the item with N rows
    is reindexed alike (``:277``)."""

    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.2,
                 **kwargs):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data, rng):
        if rng.uniform() < self.dropout_application_ratio:
            n = len(data["pos"])
            keep = rng.permutation(n)[: int(n * (1 - self.dropout_ratio))]
            refill = rng.choice(keep, n - len(keep))
            idx = np.concatenate([keep, refill])
            for k, v in data.items():
                if isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
                    data[k] = v[idx]
        return data


class PointCloudScaleAndJitter:
    """``_Scaling`` then ``_Jitter`` (``:299``)."""

    def __init__(self, scale=(2 / 3, 3 / 2), scale_xyz=(True, True, True),
                 anisotropic=True, jitter_sigma=0.01, jitter_clip=0.05,
                 mirror=(0, 0, 0), **kwargs):
        self.scaler = _Scaling(scale, anisotropic, scale_xyz, mirror)
        self.jitter = _Jitter(jitter_sigma, jitter_clip)

    def __call__(self, data, rng):
        return self.jitter(self.scaler(data, rng), rng)


class ChromaticNormalize:
    """Colours (divided by 255 when above 1) standardised by
    ``color_mean`` and ``color_std`` (``:328``)."""

    def __init__(self, color_mean=(0.5136, 0.4509, 0.3890),
                 color_std=(0.2926, 0.2764, 0.2759), **kwargs):
        self.mean = np.asarray(color_mean, dtype=np.float32)
        self.std = np.asarray(color_std, dtype=np.float32)

    def __call__(self, data, rng):
        if "x" in data:
            x = data["x"].copy()
            c = x[:, :3]
            if c.max() > 1.0:
                c = c / 255.0
            x[:, :3] = (c - self.mean) / self.std
            data["x"] = x
        return data


class Cutmix:
    """Point-cloud cutmix (``:349``): nothing per item; ``mix_batch``
    mixes a collated batch in place. For each of ``num_mix`` rounds that
    pass ``prob``: a permutation of the batch, ``lam ~ Beta(1, 1)``, and
    in each cloud b the ``int(N * lam)`` points nearest a random anchor
    take the rows of cloud ``perm[b]`` at the same indices. ``pos`` is the
    batch's own array, so a later cloud copies rows that an earlier one
    already mixed, as in ``geot_tpu``."""

    def __init__(self, prob=0.5, num_mix=1, **kwargs):
        self.prob = prob
        self.num_mix = num_mix

    def __call__(self, data, rng):
        return data

    def mix_batch(self, batch, rng):
        pos, y = batch["pos"], batch["y"]
        B, N = y.shape
        for _ in range(self.num_mix):
            if rng.uniform() > self.prob:
                continue
            perm = rng.permutation(B)
            lam = rng.beta(1.0, 1.0)
            n_mix = int(N * lam)
            if n_mix == 0:
                continue
            anchor = rng.integers(0, N, B)
            for b in range(B):
                d = ((pos[b] - pos[b, anchor[b]]) ** 2).sum(-1)
                idx = np.argsort(d)[:n_mix]
                src = perm[b]
                pos[b, idx] = batch["pos"][src, idx]
                y[b, idx] = batch["y"][src, idx]
        batch["pos"], batch["y"] = pos, y
        return batch


class RandomScale(_Scaling):
    """Isotropic ``_Scaling`` in [0.9, 1.1] by default (``:386``)."""

    def __init__(self, scale=(0.9, 1.1), anisotropic=False, **kwargs):
        super().__init__(scale, anisotropic, (True, True, True), (0, 0, 0))


class RandomShift:
    """A shift uniform in each axis's ``(lo, hi)`` (``:394``)."""

    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0)), **kwargs):
        self.shift = shift

    def __call__(self, data, rng):
        t = np.asarray([rng.uniform(lo, hi) for lo, hi in self.shift],
                       dtype=np.float32)
        data["pos"] = data["pos"] + t
        return data


class RandomHorizontalFlip:
    """With probability ``aug_prob``, each axis but the upright one is
    flipped about the cloud's largest coordinate with probability 1/2;
    ``normals`` flip sign in place (``:408``)."""

    def __init__(self, upright_axis="z", aug_prob=0.95, **kwargs):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.aug_prob = aug_prob

    def __call__(self, data, rng):
        if rng.uniform() < self.aug_prob:
            for ax in set(range(3)) - {self.upright_axis}:
                if rng.uniform() < 0.5:
                    pos = data["pos"].copy()
                    pos[:, ax] = pos.max() - pos[:, ax]
                    data["pos"] = pos
                    if "normals" in data:
                        data["normals"][:, ax] = -data["normals"][:, ax]
        return data


def _rodrigues_ref(axis: np.ndarray, theta: float) -> np.ndarray:
    """``expm`` of ``np.cross(np.eye(3), axis / |axis| * theta)`` in closed
    form (``:434``): K, the rows ``e_i x a``, is skew-symmetric, so
    ``expm(theta K) = I + sin(theta) K + (1 - cos(theta)) K^2``."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    K = np.cross(np.eye(3), a)
    s, c = np.sin(theta), np.cos(theta)
    return (np.eye(3) + s * K + (1.0 - c) * (K @ K)).astype(np.float32)


class RandomRotateZ:
    """Rotation about axis ``rotate_dim`` by a uniform angle in
    ``±angle * pi`` (the fixed ``angle * pi`` without ``random_rotate``),
    as ``pos @ R`` (``:448``)."""

    def __init__(self, angle=1.0, rotate_dim=2, random_rotate=True,
                 **kwargs):
        self.angle = float(angle) * np.pi
        self.random_rotate = bool(random_rotate)
        self.axis = np.zeros(3, dtype=np.float64)
        self.axis[rotate_dim] = 1.0

    def __call__(self, data, rng):
        theta = rng.uniform(-self.angle, self.angle) if self.random_rotate \
            else self.angle
        R = _rodrigues_ref(self.axis, theta)
        data["pos"] = (data["pos"] @ R).astype(np.float32)
        return data


class RandomScaleAndJitter:
    """One scale draw (three with ``scale_anisotropic``), mirrored where a
    draw passes ``mirror``, axes off in ``scale_xyz`` at 1, then clipped
    gaussian jitter in float64, cast to float32 (``:469``)."""

    def __init__(self, scale=(0.8, 1.2), scale_xyz=(True, True, True),
                 scale_anisotropic=False, jitter_sigma=0.01, jitter_clip=0.05,
                 mirror=(-1, -1, -1), **kwargs):
        self.scale = scale
        self.scale_xyz = scale_xyz
        self.anisotropic = bool(scale_anisotropic)
        self.sigma, self.clip = jitter_sigma, jitter_clip
        self.mirror = np.asarray(mirror)

    def __call__(self, data, rng):
        scale = rng.uniform(self.scale[0], self.scale[1],
                            3 if self.anisotropic else 1).astype(np.float32)
        if len(scale) == 1:
            scale = scale.repeat(3)
        if (self.mirror > 0).any():
            m = (rng.uniform(size=3) > self.mirror).astype(np.float32) * 2 - 1
            scale = scale * m
        for i, s in enumerate(self.scale_xyz):
            if not s:
                scale[i] = 1.0
        jitter = np.clip(self.sigma * rng.standard_normal(
            (data["pos"].shape[0], 3)), -self.clip, self.clip)
        data["pos"] = (data["pos"] * scale + jitter).astype(np.float32)
        return data


class RandomScaleAndTranslate:
    """One scale draw masked by ``scale_xyz``, then a shift uniform in
    ``[-shift, shift]`` per axis (``:500``)."""

    def __init__(self, scale=(0.9, 1.1), shift=(0.2, 0.2, 0),
                 scale_xyz=(1, 1, 1), **kwargs):
        self.scale = scale
        self.shift = np.asarray(shift, dtype=np.float32)
        self.scale_xyz = np.asarray(scale_xyz, dtype=np.float32)

    def __call__(self, data, rng):
        scale = np.repeat(rng.uniform(self.scale[0], self.scale[1], 1), 3)
        scale = scale.astype(np.float32) * self.scale_xyz
        shift = rng.uniform(-1.0, 1.0, 3).astype(np.float32) * self.shift
        data["pos"] = (data["pos"] * scale + shift).astype(np.float32)
        return data


class RandomFlip:
    """x and y sign flips, each with probability ``p`` (``:522``)."""

    def __init__(self, p=0.5, **kwargs):
        self.p = float(p)

    def __call__(self, data, rng):
        pos = data["pos"].copy()
        if rng.uniform() < self.p:
            pos[:, 0] = -pos[:, 0]
        if rng.uniform() < self.p:
            pos[:, 1] = -pos[:, 1]
        data["pos"] = pos
        return data


class RandomJitter(_Jitter):
    """``:540``."""

    def __init__(self, jitter_sigma=0.01, jitter_clip=0.05, **kwargs):
        super().__init__(jitter_sigma, jitter_clip)


class ChromaticAutoContrast:
    """With probability ``p``, colours blended (by ``blend_factor``, or a
    uniform draw) toward their per-cloud min-max stretch to [0, 255]
    (``:549``)."""

    def __init__(self, p=0.2, blend_factor=None, **kwargs):
        self.p = float(p)
        self.blend_factor = blend_factor

    def __call__(self, data, rng):
        if rng.uniform() < self.p:
            x = data["x"].copy().astype(np.float32)
            lo = x[:, :3].min(0, keepdims=True)
            hi = x[:, :3].max(0, keepdims=True)
            contrast = (x[:, :3] - lo) * (255.0 / (hi - lo))
            blend = rng.uniform() if self.blend_factor is None \
                else self.blend_factor
            x[:, :3] = (1 - blend) * x[:, :3] + blend * contrast
            data["x"] = x
        return data


class ChromaticTranslation:
    """With probability ``p``, one colour shift of up to ``ratio * 255`` a
    channel, clipped to [0, 255] (``:571``)."""

    def __init__(self, p=0.95, ratio=0.05, **kwargs):
        self.p, self.ratio = float(p), float(ratio)

    def __call__(self, data, rng):
        if rng.uniform() < self.p:
            x = data["x"].copy().astype(np.float32)
            tr = (rng.uniform(size=(1, 3)) - 0.5) * 255 * 2 * self.ratio
            x[:, :3] = np.clip(tr + x[:, :3], 0, 255)
            data["x"] = x
        return data


class ChromaticJitter:
    """With probability ``p``, gaussian colour noise of ``std * 255`` a
    point, clipped to [0, 255] (``:588``)."""

    def __init__(self, p=0.95, std=0.005, **kwargs):
        self.p, self.std = float(p), float(std)

    def __call__(self, data, rng):
        if rng.uniform() < self.p:
            x = data["x"].copy().astype(np.float32)
            noise = rng.standard_normal((x.shape[0], 3)) * self.std * 255
            x[:, :3] = np.clip(noise + x[:, :3], 0, 255)
            data["x"] = x
        return data


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """``colorsys.rgb_to_hsv`` over [0, 255] arrays, in float64; channels
    past the third pass through (``:604``)."""
    rgb = rgb.astype(np.float64)
    hsv = np.zeros_like(rgb)
    hsv[..., 3:] = rgb[..., 3:]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = np.max(rgb[..., :3], axis=-1)
    minc = np.min(rgb[..., :3], axis=-1)
    hsv[..., 2] = maxc
    mask = maxc != minc
    hsv[mask, 1] = (maxc - minc)[mask] / maxc[mask]
    rc, gc, bc = np.zeros_like(r), np.zeros_like(g), np.zeros_like(b)
    rc[mask] = (maxc - r)[mask] / (maxc - minc)[mask]
    gc[mask] = (maxc - g)[mask] / (maxc - minc)[mask]
    bc[mask] = (maxc - b)[mask] / (maxc - minc)[mask]
    hsv[..., 0] = np.select([r == maxc, g == maxc],
                            [bc - gc, 2.0 + rc - bc], default=4.0 + gc - rc)
    hsv[..., 0] = (hsv[..., 0] / 6.0) % 1.0
    return hsv


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``colorsys.hsv_to_rgb``, truncated to uint8 (``:626``)."""
    rgb = np.empty_like(hsv)
    rgb[..., 3:] = hsv[..., 3:]
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype("uint8")
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
    return rgb.astype("uint8")


class HueSaturationTranslation:
    """A hue turn uniform in ``±hue_max`` and a saturation scale in
    ``1 ± saturation_max``, through HSV and back to uint8 colours
    (``:646``)."""

    rgb_to_hsv = staticmethod(_rgb_to_hsv)
    hsv_to_rgb = staticmethod(_hsv_to_rgb)

    def __init__(self, hue_max=0.5, saturation_max=0.2, **kwargs):
        self.hue_max = float(hue_max)
        self.saturation_max = float(saturation_max)

    def __call__(self, data, rng):
        x = data["x"].copy().astype(np.float32)
        hsv = _rgb_to_hsv(x[:, :3])
        hue_val = (rng.uniform() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (rng.uniform() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        x[:, :3] = np.clip(_hsv_to_rgb(hsv), 0, 255)
        data["x"] = x
        return data


class RandomDropFeature:
    """With probability ``feature_drop``, channels ``drop_dim[0]`` to
    ``drop_dim[-1]`` of ``x`` set to 0 (``:670``)."""

    def __init__(self, feature_drop=0.2, drop_dim=(0, 3), **kwargs):
        self.p = float(feature_drop)
        self.dim = list(drop_dim)

    def __call__(self, data, rng):
        if rng.uniform() < self.p:
            x = data["x"].copy()
            x[:, self.dim[0]:self.dim[-1]] = 0
            data["x"] = x
        return data


class NumpyChromaticNormalize:
    """Colours in [0, 255] to [0, 1], then standardised when
    ``color_mean`` / ``color_std`` are given (``:687``)."""

    def __init__(self, color_mean=None, color_std=None, **kwargs):
        self.mean = np.asarray(color_mean, np.float32) \
            if color_mean is not None else None
        self.std = np.asarray(color_std, np.float32) \
            if color_std is not None else None

    def __call__(self, data, rng):
        x = data["x"].copy().astype(np.float32)
        if x[:, :3].max() > 1:
            x[:, :3] = x[:, :3] / 255.0
        if self.mean is not None:
            x[:, :3] = (x[:, :3] - self.mean) / self.std
        data["x"] = x
        return data


class PointCloudToTensor:
    """``pos``, ``normals`` and ``colors`` as float32, channels last
    (``:708``)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, data, rng):
        for k in ("pos", "normals", "colors"):
            if k in data:
                data[k] = np.asarray(data[k], dtype=np.float32)
        return data


class PointCloudXYZAlign:
    """Centre the cloud and put its lowest point along ``gravity_dim`` at
    0 (``:725``)."""

    def __init__(self, gravity_dim=2, **kwargs):
        self.gravity_dim = int(gravity_dim)

    def __call__(self, data, rng):
        pos = data["pos"] - data["pos"].mean(axis=0, keepdims=True)
        pos[:, self.gravity_dim] -= pos[:, self.gravity_dim].min()
        data["pos"] = pos.astype(np.float32)
        return data


# every name of geot_tpu's DataTransforms registry
DataTransforms = Registry("datatransforms")
TRANSFORMS = DataTransforms      # the port's earlier name
for _cls in (
    PointsToTensor, PointCloudCenterAndNormalize, PointCloudScaling,
    PointCloudScaling_s, PointCloudTranslation, PointCloudTranslation_s,
    PointCloudScaleAndTranslate, PointCloudScaleAndTranslate_s,
    PointCloudJitter, PointCloudJitter_s, PointCloudRotation,
    PointCloudRotation_s, RandomRotate, ChromaticDropGPU,
    ChromaticPerDropGPU, RandomDropout, PointCloudScaleAndJitter,
    ChromaticNormalize, Cutmix, RandomScale, RandomShift,
    RandomHorizontalFlip, RandomRotateZ, RandomScaleAndJitter,
    RandomScaleAndTranslate, RandomFlip, RandomJitter, ChromaticAutoContrast,
    ChromaticTranslation, ChromaticJitter, HueSaturationTranslation,
    RandomDropFeature, NumpyChromaticNormalize, PointCloudToTensor,
    PointCloudXYZAlign):
    DataTransforms.register_module(module=_cls)


def build_transforms_from_cfg(split: str, datatransforms_cfg: Optional[
        Dict[str, Any]]) -> Optional[Compose]:
    """The transform list of ``split`` built with the shared ``kwargs``
    (``:44``); a name outside ``TRANSFORMS`` raises ``KeyError``."""
    cfg = dict(datatransforms_cfg or {})
    names = cfg.get(split)
    if not names:
        return None
    kwargs = dict(cfg.get("kwargs", {}))
    unknown = [n for n in names if n not in TRANSFORMS]
    if unknown:
        raise KeyError(f"transforms not ported: {unknown}; ported: "
                       f"{sorted(TRANSFORMS)}")
    return Compose([TRANSFORMS[n](**copy.deepcopy(kwargs)) for n in names])
