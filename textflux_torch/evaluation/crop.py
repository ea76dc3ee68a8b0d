"""Text-region cropping for OCR evaluation (the port of
``textflux_tpu/evaluation/crop.py``, host numpy + cv2 as there).

Re-implements the reference recognizer's crop path (eval/recognizer.py:19-72:
polygon mask -> min-area bounding rect -> similarity warp to an axis-aligned
crop) with cv2 perspective warping instead of the torch affine_grid route.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def min_bounding_rect(mask: np.ndarray) -> np.ndarray:
    """4x2 corner points (ordered tl, tr, br, bl) of the largest mask contour."""
    if cv2 is None:
        raise RuntimeError("requires cv2")
    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        raise ValueError("empty mask")
    contour = max(contours, key=cv2.contourArea)
    box = cv2.boxPoints(cv2.minAreaRect(contour))

    # order corners by x-sort then y-sort (reference recognizer.py:29-41);
    # the common sum/diff trick degenerates on ~45-degree rects (two
    # corners tie on the sum and the homography goes singular)
    x_sorted = sorted(box, key=lambda p: p[0])
    (tl, bl) = sorted(x_sorted[:2], key=lambda p: p[1])
    (tr, br) = sorted(x_sorted[2:], key=lambda p: p[1])
    return np.array([tl, tr, br, bl], np.float32)


def crop_polygon_region(
    image: np.ndarray,
    polygon: Sequence[Sequence[float]],
    *,
    target_height: int = 48,
    max_width: int = 320,
) -> np.ndarray:
    """Crop + rectify the quadrilateral text region to an axis-aligned strip.

    Returns an (target_height, W<=max_width, 3) uint8 array suitable for a CTC
    recognizer input.
    """
    if cv2 is None:
        raise RuntimeError("requires cv2")
    h, w = image.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.asarray(polygon, np.int32)], 255)
    corners = min_bounding_rect(mask)

    tl, tr, br, bl = corners
    width = int(max(np.linalg.norm(tr - tl), np.linalg.norm(br - bl)))
    height = int(max(np.linalg.norm(bl - tl), np.linalg.norm(br - tr)))
    width, height = max(width, 1), max(height, 1)
    if height > width * 1.2:
        # vertical text -> horizontal, rotating 90 deg COUNTER-clockwise and
        # at the reference threshold (eval_dgocr.py:207-208:
        # transpose(1,2).flip(dims=[1]) when h > w*1.2 == np.rot90 k=1).
        # CCW maps the source TOP-RIGHT corner to the new top-left, i.e.
        # roll the (tl,tr,br,bl) ring by -1; the old roll(+1) rotated
        # CLOCKWISE — 180 deg off the reference, upside-down glyphs
        width, height = height, width
        corners = np.roll(corners, -1, axis=0)

    dst = np.array([[0, 0], [width - 1, 0], [width - 1, height - 1], [0, height - 1]],
                   np.float32)
    m = cv2.getPerspectiveTransform(corners.astype(np.float32), dst)
    crop = cv2.warpPerspective(image, m, (width, height))

    scale = target_height / crop.shape[0]
    new_w = min(max(int(crop.shape[1] * scale), 1), max_width)
    return cv2.resize(crop, (new_w, target_height))
