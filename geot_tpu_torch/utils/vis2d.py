"""Images to a PNG file (``geot_tpu/utils/vis2d.py``)."""
from __future__ import annotations

import os

import numpy as np


def show_imgs(imgs, out: str = "vis/imgs.png"):
    """A row of images, (H, W, 3) floats in [0, 1] or (3, H, W), drawn by
    matplotlib (imported here only) to ``out``; returns ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not isinstance(imgs, (list, tuple)):
        imgs = [imgs]
    fig, axs = plt.subplots(ncols=len(imgs), squeeze=False,
                            figsize=(3 * len(imgs), 3))
    for i, img in enumerate(imgs):
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] in (1, 3) and \
                img.shape[-1] not in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        axs[0, i].imshow(np.clip(img, 0, 1))
        axs[0, i].set(xticklabels=[], yticklabels=[], xticks=[], yticks=[])
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out
