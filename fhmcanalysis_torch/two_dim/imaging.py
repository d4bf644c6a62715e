"""Native image-segmentation primitives for 2-D lnPI surfaces.

The reference leans on scikit-image for phase identification
(pore_hist.pyx:24-28: peak_local_max, watershed, find_boundaries,
profile_line).  These are small-grid operations far off the hot path
(SURVEY §7.8), implemented here from scratch so the framework carries no
scikit-image dependency.

The PyTorch port's copy of the JAX package's ``two_dim/imaging.py``; the
native flood is ``fhmcanalysis_torch/native/imaging.cpp``, built with g++ at
first use (``native.IMAGING_AVAILABLE`` says whether it or the heapq flood
runs).
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.ndimage as ndi

__all__ = ["peak_local_max", "watershed", "find_boundaries", "profile_line"]


def peak_local_max(image, min_distance=1, exclude_border=0, num_peaks=np.inf, footprint=None):
    """Coordinates of local maxima, sorted by decreasing intensity.

    A pixel is a peak when it equals the maximum over its footprint
    neighborhood and exceeds the image minimum.  Mirrors the subset of
    skimage.feature.peak_local_max semantics the reference uses
    (pore_hist.pyx:414).
    """
    image = np.asarray(image, dtype=np.float64)
    if footprint is None:
        size = 2 * min_distance + 1
        footprint = np.ones((size, size), dtype=bool)
    footprint = np.asarray(footprint, dtype=bool)

    maxed = ndi.maximum_filter(image, footprint=footprint, mode="constant", cval=-np.inf)
    is_peak = (image == maxed) & (image > image.min())

    if exclude_border:
        b = int(exclude_border)
        mask = np.zeros_like(is_peak)
        mask[b:-b, b:-b] = True
        is_peak &= mask

    coords = np.argwhere(is_peak)
    if len(coords) == 0:
        return coords
    intensities = image[coords[:, 0], coords[:, 1]]
    order = np.argsort(-intensities, kind="stable")
    coords = coords[order]
    if np.isfinite(num_peaks) and len(coords) > num_peaks:
        coords = coords[: int(num_peaks)]
    return coords


def _offsets_from_footprint(footprint):
    fp = np.asarray(footprint, dtype=bool)
    cy, cx = (fp.shape[0] - 1) // 2, (fp.shape[1] - 1) // 2
    offs = [(i - cy, j - cx) for i, j in np.argwhere(fp) if not (i == cy and j == cx)]
    return offs


def watershed(image, markers, mask=None, connectivity=None):
    """Priority-flood watershed segmentation.

    Floods ``image`` (lower values flood first) from the labeled marker
    pixels; each unlabeled pixel joins the label of the neighbor that
    reached it first in elevation order.  Mirrors the subset of
    skimage.morphology.watershed the reference uses (pore_hist.pyx:423).

    connectivity may be a footprint array defining the neighborhood.

    Dispatches to the native C++ flood (native/imaging.cpp) when a
    compiler is available; the Python heapq fallback below is flood-order
    identical.  NaN elevations are treated as +inf (flood last): both the
    C++ std::priority_queue comparator and Python tuple comparison have
    undefined ordering for NaN, so they are normalized away up front.
    """
    image = np.asarray(image, dtype=np.float64)
    if np.isnan(image).any():
        image = np.where(np.isnan(image), np.inf, image)
    labels = np.array(markers, dtype=np.int64, copy=True)
    if mask is None:
        mask = np.ones(image.shape, dtype=bool)
    else:
        mask = np.asarray(mask, dtype=bool)
    if connectivity is None:
        offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    elif np.isscalar(connectivity):
        if connectivity == 1:
            offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
        else:
            offs = [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if (i, j) != (0, 0)]
    else:
        offs = _offsets_from_footprint(connectivity)

    from ..native import watershed_native

    native = watershed_native(image, labels, mask, np.asarray(offs, dtype=np.int64))
    if native is not None:
        return native

    H, W = image.shape
    heap = []
    counter = 0
    for i, j in np.argwhere((labels > 0) & mask):
        heapq.heappush(heap, (image[i, j], counter, int(i), int(j)))
        counter += 1

    while heap:
        _, _, i, j = heapq.heappop(heap)
        lab = labels[i, j]
        for di, dj in offs:
            ni, nj = i + di, j + dj
            if 0 <= ni < H and 0 <= nj < W and mask[ni, nj] and labels[ni, nj] == 0:
                labels[ni, nj] = lab
                heapq.heappush(heap, (image[ni, nj], counter, ni, nj))
                counter += 1

    labels[~mask] = 0
    return labels


def find_boundaries(label_img, connectivity=1, mode="inner", background=0):
    """Boolean mask of inner boundary pixels between differing labels.

    Mirrors skimage.segmentation.find_boundaries(mode='inner') as used at
    pore_hist.pyx:430: a non-background pixel is a boundary pixel when
    any neighbor carries a different label.
    """
    lab = np.asarray(label_img)
    H, W = lab.shape
    if connectivity == 1:
        offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    else:
        offs = [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if (i, j) != (0, 0)]

    out = np.zeros(lab.shape, dtype=bool)
    padded = np.pad(lab, 1, mode="edge")  # image borders are not boundaries
    for di, dj in offs:
        shifted = padded[1 + di : 1 + di + H, 1 + dj : 1 + dj + W]
        out |= (lab != shifted) & (lab != background)
    return out


def profile_line(image, src, dst, linewidth=1, order=0, cval=0.0):
    """Sample image values along the line src -> dst.

    Nearest-neighbor (order=0) variant of skimage.measure.profile_line as
    used at pore_hist.pyx:464: ceil(length)+1 evenly spaced samples,
    out-of-bounds reads return cval.
    """
    image = np.asarray(image, dtype=np.float64)
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    length = int(np.ceil(np.hypot(*(dst - src)))) + 1
    rows = np.linspace(src[0], dst[0], length)
    cols = np.linspace(src[1], dst[1], length)
    ri = np.round(rows).astype(int)
    ci = np.round(cols).astype(int)
    inside = (ri >= 0) & (ri < image.shape[0]) & (ci >= 0) & (ci < image.shape[1])
    out = np.full(length, cval, dtype=np.float64)
    out[inside] = image[ri[inside], ci[inside]]
    return out
