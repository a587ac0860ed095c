"""Bicubic resize of uint8 images in numpy: the port's stand-in for
`cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`.

The training data synthesis of the JAX package (`synthesize_lr`, the
collage's seam repair) degrades depth with OpenCV's bicubic resize; the
card's machine has no OpenCV, so the port carries its arithmetic:

  * the source coordinate of output pixel d is (d + 0.5) * (src / dst) -
    0.5, its floor the second of four taps and its fraction t;
  * Keys' cubic with A = -0.75 gives the four weights, the last one
    1 - the other three; taps beyond the border repeat the edge pixel;
  * rows first, then columns, each a float32 sum of four products in tap
    order; the result is rounded half to even and saturated to [0, 255].

OpenCV takes two routes for uint8 and this module follows both: when both
sides of the source are at least 4 pixels it computes the coordinate and
the weights in float64 and sums in float32 (the route above); a smaller
source goes through OpenCV's fixed-point route, weights rounded to 11
bits, integer sums, and (sum + 2^21) >> 22. Against OpenCV 5.0 on random
images this is exact at 33 x 29 and 64 x 80 (but for ties of a 2 x 1
source), and 1 code off on about 1 in 10^5 pixels at 463 x 370, where a
float32 sum lands within a few ulps of a rounding boundary
(tests/test_torch_resize.py). No other order of the four products
closes that (sequential, pairwise, reversed, fused multiply-adds, columns
first: 9-16 pixels of ~10^6 each), so the rest is in how OpenCV's own
route makes its weights.
"""
from __future__ import annotations

import numpy as np

A = -0.75                 # Keys' cubic, OpenCV's INTER_CUBIC constant
COEF_BITS = 11            # OpenCV's fixed-point weight precision
FLOAT_ROUTE_MIN = 4       # the float route needs a source this size a side


def _taps(dst: int, src: int, dtype):
    """-> (indices (dst, 4) into the source, weights (dst, 4) in `dtype`):
    float64 for the float route, float32 (OpenCV's own type there) for the
    fixed-point route."""
    fx = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(dtype)
    sx = np.floor(fx)
    x = (fx - sx).astype(dtype)
    a = dtype(A)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3)[None],
                  0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(dtype)


def resize_cubic(img: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W) -> uint8 (h, w) for size = (w, h), OpenCV's order."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"resize_cubic takes uint8 (H, W), got "
                         f"{img.dtype} {img.shape}")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize_cubic: empty output size {size}")
    H, W = img.shape
    if min(H, W) >= FLOAT_ROUTE_MIN:
        ix, cx = _taps(w, W, np.float64)
        iy, cy = _taps(h, H, np.float64)
        cx, cy = cx.astype(np.float32), cy.astype(np.float32)
        src = img.astype(np.float32)
        rows = np.zeros((H, w), np.float32)
        for k in range(4):
            rows += src[:, ix[:, k]] * cx[:, k]
        out = np.zeros((h, w), np.float32)
        for k in range(4):
            out += rows[iy[:, k]] * cy[:, k, None]
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    ix, cx = _taps(w, W, np.float32)
    iy, cy = _taps(h, H, np.float32)
    one = 1 << COEF_BITS
    cx = np.rint(cx * one).astype(np.int64)
    cy = np.rint(cy * one).astype(np.int64)
    src = img.astype(np.int64)
    rows = sum(src[:, ix[:, k]] * cx[:, k] for k in range(4))
    out = sum(rows[iy[:, k]] * cy[:, k, None] for k in range(4))
    return np.clip((out + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS),
                   0, 255).astype(np.uint8)


def _area_fast(img: np.ndarray, sy: int, sx: int) -> np.ndarray:
    """OpenCV's integer-factor route (`resizeAreaFast_`): each output pixel
    the integer sum of its sy x sx block, times the float32 1 / area,
    rounded half to even; a 2 x 2 block takes its SIMD route instead,
    (sum + 2) >> 2."""
    H, W = img.shape
    blocks = img.astype(np.int64).reshape(H // sy, sy, W // sx, sx)
    s = blocks.sum(axis=(1, 3))
    if sy == 2 and sx == 2:
        return ((s + 2) >> 2).astype(np.uint8)
    scale = np.float32(1.0) / np.float32(sy * sx)
    return np.clip(np.rint(s.astype(np.float32) * scale), 0,
                   255).astype(np.uint8)


def _area_tab(src: int, dst: int, scale: float):
    """OpenCV's `computeResizeAreaTab`: for each output pixel the source
    pixels its cell covers and their float32 weights, cell fractions over
    the cell width -> (indices (dst, K), weights (dst, K)), each row in
    OpenCV's order and padded with zero weights."""
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, np.float32((s1 - f1) / cell)))
        taps.extend((s, np.float32(1.0 / cell)) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            taps.append((s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                        / cell)))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    wt = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W) -> uint8 (h, w) for size = (w, h), OpenCV's
    `cv2.resize(img, size, interpolation=cv2.INTER_AREA)` when shrinking
    (h <= H, w <= W), bitwise: the pyramid levels of `PatchSampler`.

    OpenCV's two routes for uint8, both here. The scale of each axis is
    1 / (out / in) in float64. When both are whole numbers (within float64
    epsilon), the block-mean route (`_area_fast`). Otherwise each axis's
    cell of `scale` source pixels covers whole pixels and a fraction at
    each end (`_area_tab`): a row is the float32 sum of its source pixels
    times their weights, in order, and the output pixel the float32 sum
    of its rows times theirs, rounded half to even and saturated.
    Same size: a copy."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"resize_area takes uint8 (H, W), got "
                         f"{img.dtype} {img.shape}")
    w, h = int(size[0]), int(size[1])
    H, W = img.shape
    if not (1 <= h <= H and 1 <= w <= W):
        raise ValueError(f"resize_area shrinks or copies: {W}x{H} -> "
                         f"{w}x{h}")
    if (h, w) == (H, W):
        return img.copy()
    scale_x, scale_y = 1.0 / (w / W), 1.0 / (h / H)
    ix, iy = round(scale_x), round(scale_y)
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        return _area_fast(img, iy, ix)
    xi, xw = _area_tab(W, w, scale_x)
    yi, yw = _area_tab(H, h, scale_y)
    src = img.astype(np.float32)
    out = np.zeros((h, w), np.float32)
    for j in range(yi.shape[1]):
        row = np.zeros((h, w), np.float32)
        s = src[yi[:, j]]
        for k in range(xi.shape[1]):
            row += s[:, xi[:, k]] * xw[:, k]
        out += yw[:, j, None] * row
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
