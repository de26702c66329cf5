"""Auto-overlap detection: find the duplicated strip between consecutive
screenshots so the stitcher can trim it (``StitchOptions.merge_overlap``).

Port of ``imagestitching_tpu/ops/overlap.py``.  The host half --
``_scores_numpy``, ``detect_pair``, ``detect_trims`` and ``apply_trims`` --
is the original's code (``tests/test_torch_standalone.py`` holds it equal);
``merge_arrays`` takes the job's torch device; the device scorer
``_scores_torch`` is the twin of ``_device_scorer`` (:84-102) in torch ops.

Algorithm (vertical; horizontal transposes and reuses it):

1. Template = top ``strip`` rows of image B.  Search region = bottom
   ``o_max`` rows of image A (``o_max = max_frac * min(hA, hB)``, capped at
   ``hB - 1`` so a trim can never empty an image).
2. Score every vertical position ``p`` by the mean per-pixel SSD between the
   template and the region window at ``p``.  SSD expands to
   ``||a||^2 - 2 a.b + ||b||^2``: the cross term is ONE (R x W*C x k)
   matmul, the ``||a||^2`` term a cumsum of row energy.
3. The ``top_c`` best positions are verified EXACTLY on the host: overlap
   ``o = R - p`` is accepted iff the full candidate overlap region's mean
   absolute difference (integer arithmetic, float64 mean) is <= threshold.
   Among accepted candidates the best exact diff wins; ties prefer the
   larger overlap.  No candidate verified -> no trim (0).

The device scorer computes in float64 on the job's device (the product is
at most ``o_max x W*C`` by ``W*C x strip``), so its scores equal
``_scores_numpy``'s to about 1e-12 and the candidates the exact verify sees
are the numpy scorer's; no TF32 setting reaches it.  ``device`` is a torch
device (``True`` means ``cuda``), or ``False``/``None`` for the numpy
scorer.  A fault of the device scorer propagates: nothing falls back to
the host.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_MIN_STRIP = 4          # below this the template carries too little signal


def _scores_numpy(region: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Float64 reference scorer: mean per-pixel SSD of the k-row template
    against every window position in the region.  Same formulation as the
    device path (matmul + cumsum) so the two differ only in precision."""
    r, k = region.shape[0], template.shape[0]
    rm = region.reshape(r, -1).astype(np.float64) / 255.0
    tm = template.reshape(k, -1).astype(np.float64) / 255.0
    p = r - k + 1
    cmat = rm @ tm.T                                  # (R, k)
    cross = np.zeros(p)
    for j in range(k):
        cross += cmat[j:j + p, j]
    r2 = np.square(rm).sum(axis=1)
    csum = np.concatenate([[0.0], np.cumsum(r2)])
    a2 = csum[k:k + p] - csum[:p]
    b2 = float(np.square(tm).sum())
    return (a2 - 2.0 * cross + b2) / float(k * rm.shape[1])


def scorer_device(device):
    """The torch device of the scorer for a ``device`` argument: ``True``
    -> ``cuda``, a string or ``torch.device`` -> that device (a CUDA device
    on a host without one raises), ``False``/``None`` -> None (the numpy
    scorer)."""
    if device is None or device is False:
        return None
    from ..runtime.pipeline import resolve_device
    return resolve_device("cuda" if device is True else device)


def _scores_torch(region: np.ndarray, template: np.ndarray,
                  device) -> np.ndarray:
    """``_scores_numpy`` in float64 torch ops on ``device``: the cross term
    ``cmat[j + p, j]`` summed over ``j`` is one strided view of the
    ``(R, k)`` product."""
    import torch

    r, k = region.shape[0], template.shape[0]
    rm = torch.from_numpy(np.ascontiguousarray(region).reshape(r, -1)).to(
        device).to(torch.float64) / 255.0
    tm = torch.from_numpy(np.ascontiguousarray(template).reshape(k, -1)).to(
        device).to(torch.float64) / 255.0
    p = r - k + 1
    cmat = (rm @ tm.T).contiguous()                   # (R, k)
    cross = cmat.as_strided((p, k), (k, k + 1)).sum(1)
    r2 = rm.square().sum(1)
    csum = torch.cat([r2.new_zeros(1), torch.cumsum(r2, 0)])
    a2 = csum[k:k + p] - csum[:p]
    b2 = tm.square().sum()
    return ((a2 - 2.0 * cross + b2) / float(k * rm.shape[1])).cpu().numpy()


def _scores(region: np.ndarray, template: np.ndarray,
            device) -> np.ndarray:
    dev = scorer_device(device)
    if dev is None:
        return _scores_numpy(region, template)
    return _scores_torch(region, template, dev)


def detect_pair(a: np.ndarray, b: np.ndarray, *, threshold: float = 2.0,
                max_frac: float = 0.5, strip: int = 32, top_c: int = 4,
                device: bool = True) -> int:
    """Rows of ``b``'s top that duplicate ``a``'s bottom (0 = no overlap).

    ``a``/``b`` are display-oriented HWC uint8 arrays of equal width and
    channel count (anything else returns 0 -- a mismatched pair cannot
    overlap pixel-for-pixel).  ``device``: see the module docstring.
    """
    if a.ndim != 3 or b.ndim != 3 or a.shape[1:] != b.shape[1:]:
        return 0
    ha, hb = int(a.shape[0]), int(b.shape[0])
    k = min(int(strip), ha, hb)
    if k < _MIN_STRIP:
        return 0
    o_max = min(int(max_frac * min(ha, hb)), hb - 1, ha)
    if o_max < k:
        return 0
    region = a[ha - o_max:]
    template = b[:k]
    scores = _scores(region, template, device)
    order = np.argsort(scores, kind="stable")[:max(1, int(top_c))]
    best_o, best_d = 0, None
    for p in order:
        o = o_max - int(p)
        d = float(np.abs(a[ha - o:].astype(np.int16)
                         - b[:o].astype(np.int16)).mean(dtype=np.float64))
        if d <= threshold and (best_d is None or d < best_d
                               or (d == best_d and o > best_o)):
            best_o, best_d = o, d
    return best_o


def detect_trims(arrays: Sequence[np.ndarray], direction: str = "vertical",
                 *, threshold: float = 2.0, max_frac: float = 0.5,
                 strip: int = 32, top_c: int = 4,
                 device: bool = True) -> List[int]:
    """Per-image leading-edge trim (rows for vertical, columns for
    horizontal); ``trims[0]`` is always 0.  Pairs are independent -- a trim
    removes image i's LEADING edge, which never participates in the
    (i, i+1) comparison, so detection runs on the original arrays."""
    if direction not in ("vertical", "horizontal"):
        raise ValueError(f"direction must be vertical/horizontal, "
                         f"got {direction!r}")
    views = [np.asarray(a) for a in arrays]
    if direction == "horizontal":
        views = [a.transpose(1, 0, 2) if a.ndim == 3 else a.T
                 for a in views]
    trims = [0]
    for prev, cur in zip(views, views[1:]):
        trims.append(detect_pair(prev, cur, threshold=threshold,
                                 max_frac=max_frac, strip=strip,
                                 top_c=top_c, device=device))
    return trims


def merge_arrays(images: Sequence[np.ndarray], specs, options, device):
    """``StitchOptions.merge_overlap`` pre-pass shared by api and serve:
    orient to display space (host-side; index-permutation views only),
    detect duplicated strips along the stitch axis with the scorer on
    ``device`` (the job's torch device), crop them (views).

    Returns ``(images, specs, trims)`` where specs carry orientation=1 --
    the downstream pipeline sees ordinary pre-oriented arrays, so merge
    composes with every engine/strategy without touching them.
    """
    from ..core import geometry
    from ..core.layout import ImageSpec
    oriented = [geometry.orient_array(np.asarray(img), s.orientation)
                for img, s in zip(images, specs)]
    trims = detect_trims(oriented, options.direction,
                         threshold=options.merge_threshold, device=device)
    if any(trims):
        oriented = apply_trims(oriented, trims, options.direction)
    new_specs = [ImageSpec(a.shape[1], a.shape[0]) for a in oriented]
    return oriented, new_specs, trims


def apply_trims(arrays: Sequence[np.ndarray], trims: Sequence[int],
                direction: str = "vertical") -> List[np.ndarray]:
    """Crop each image's leading stitch-axis edge by its trim (views -- no
    pixel copies)."""
    out = []
    for a, t in zip(arrays, trims):
        if t <= 0:
            out.append(a)
        elif direction == "vertical":
            out.append(a[t:])
        else:
            out.append(a[:, t:])
    return out
