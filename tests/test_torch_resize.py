"""The port's bicubic and area resizes (`codon_tpu_torch.data.resize`)
against OpenCV's `cv2.resize(..., INTER_CUBIC)` and `INTER_AREA`, which
the JAX package's training data synthesis and its sampler's pyramid call.

`resize_area` is bitwise OpenCV's on uint8 at every size: whole factors
(the block-mean route, the 2 x 2 block's own rounding included), other
factors (fractional box weights, float32 sums), odd sizes, one axis at
factor 1, and a copy at the same size.

Tolerances, and why, on random images from a seed, down by 4, 8 and 16
and back up:
- 33 x 29 and 64 x 80: exact (every pixel), but one case below.
- 463 x 370: the port sums in float32 in another order than OpenCV's
  vectorized loops, so a value within a few float32 ulps of a .5 boundary
  may round the other way: at most 1 code off, on at most 1 pixel in 10^4
  (the runs here read 0 down and 1 pixel of 171,310 up at each scale).
- A source with a side under 4 pixels takes OpenCV's fixed-point route
  (11-bit weights, integer sums), which the port repeats; exact at 33 x 29
  by 8 (a 4 x 3 source). Up from the 2 x 1 source of 33 x 29 by 16 a
  horizontal value lands exactly on a .5 tie that OpenCV resolves the
  other way in some rows: at most 1 code off on at most 5% of pixels (21
  of 957 here).
"""
import cv2
import numpy as np
import pytest

from codon_tpu_torch.data.resize import resize_area, resize_cubic

from torch_port_common import one_torch_thread  # noqa: F401

SIZES = [(29, 33), (80, 64), (370, 463)]
# (h, w, scale, direction) -> the share of pixels that may be 1 code off;
# every other case is exact
OFF_BY_ONE = {**{(370, 463, s, d): 1e-4 for s in (4, 8, 16)
                 for d in ("down", "up")},
              (29, 33, 16, "up"): 0.05}


def _check(got, want, case):
    share = OFF_BY_ONE.get(case)
    if share is None:
        np.testing.assert_array_equal(got, want)
        return
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1
    assert (d > 0).mean() <= share, (d > 0).sum()


@pytest.mark.parametrize("scale", [4, 8, 16])
@pytest.mark.parametrize("hw", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_down_and_up_match_opencv(hw, scale):
    h, w = hw
    img = (np.random.RandomState(h * w + scale).rand(h, w) * 255).astype(
        np.uint8)
    size = (max(1, w // scale), max(1, h // scale))
    down = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
    _check(resize_cubic(img, size), down, (h, w, scale, "down"))
    # back up from OpenCV's own low-resolution image: the two directions
    # are held apart
    up = cv2.resize(down, (w, h), interpolation=cv2.INTER_CUBIC)
    _check(resize_cubic(down, (w, h)), up, (h, w, scale, "up"))


def test_depth_like_edges_match_opencv():
    """A piecewise-constant depth map (what synthesize_lr degrades): the
    cubic's overshoot at the steps saturates at 0 and 255 as OpenCV's."""
    rng = np.random.RandomState(3)
    img = np.zeros((64, 80), np.uint8)
    img[:, 30:] = 250
    img[20:40, 10:50] = 3
    img += (rng.rand(64, 80) * 4).astype(np.uint8)
    for scale in (4, 8, 16):
        size = (80 // scale, 64 // scale)
        down = cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)
        np.testing.assert_array_equal(resize_cubic(img, size), down)
        np.testing.assert_array_equal(
            resize_cubic(down, (80, 64)),
            cv2.resize(down, (80, 64), interpolation=cv2.INTER_CUBIC))


def test_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        resize_cubic(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        resize_cubic(np.zeros((4, 4, 1), np.uint8), (2, 2))
    with pytest.raises(ValueError):
        resize_cubic(np.zeros((4, 4), np.uint8), (0, 2))


# (H, W) sources and (h, w) targets: the sampler's pyramid at 0.5, 0.6
# and 0.75 of a Middlebury frame and of small odd frames; whole factors
# 2, 3, 4 and mixed (2, 3), (1, 2); a copy
AREA_CASES = [((370, 463), (185, 231)), ((370, 463), (222, 277)),
              ((370, 463), (277, 347)), ((75, 67), (37, 33)),
              ((75, 67), (56, 50)), ((33, 29), (32, 29)), ((17, 15), (5, 4)),
              ((64, 80), (32, 40)), ((63, 81), (21, 27)), ((64, 80), (16, 20)),
              ((60, 90), (30, 30)), ((48, 36), (48, 18)), ((31, 47), (31, 47))]


@pytest.mark.parametrize("kind", ["random", "depth"])
@pytest.mark.parametrize("src,dst", AREA_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_area_matches_opencv(src, dst, kind):
    (H, W), (h, w) = src, dst
    rng = np.random.RandomState(H * W + h)
    if kind == "random":
        img = (rng.rand(H, W) * 256).astype(np.uint8)
    else:
        img = np.zeros((H, W), np.uint8)
        img[:, W // 3:] = 251
        img[H // 4:H // 2, : W // 2] = 7
        img += (rng.rand(H, W) * 4).astype(np.uint8)
    np.testing.assert_array_equal(
        resize_area(img, (w, h)),
        cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))


def test_area_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        resize_area(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError, match="shrinks or copies"):
        resize_area(np.zeros((4, 4), np.uint8), (8, 2))
