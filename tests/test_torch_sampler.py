"""The port's patch sampler (`codon_tpu_torch.train.data`) against
`codon_tpu.train.data`, and the sampler contract of tests/test_sampler.py
and tests/test_train.py.

Tolerances, and why:
- with the degraded inputs given, `sample_at(step)` is bitwise JAX's: the
  same numpy draws in the same order, the same float32 arithmetic;
- with synthesized degradation the port's bicubic resize stands in for
  OpenCV's, at most 1 code off on a few pixels (tests/test_torch_resize.py),
  so the depth patches are within 1/255 (times the affine's scale, <= 1)
  and at most 1% of their pixels differ; label and color stay bitwise.
- the pyramid: its levels' labels and colors are OpenCV's INTER_AREA,
  which the port repeats bitwise (`resize_area`), so they and the level-0
  patches are bitwise JAX's; a higher level's degraded map is synthesized
  from its labels, so it and its depth patches are in the class above.
"""
import numpy as np
import pytest

from codon_tpu.train.data import PatchSampler as JaxSampler
from codon_tpu.train.data import synthesize_lr as jax_synthesize_lr

from codon_tpu_torch.train.data import PatchSampler, synthesize_lr

from torch_port_common import one_torch_thread  # noqa: F401

SYN_SHARE = 0.01


def _imgs(n=3, h=70, w=61, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda: [(rng.rand(h, w) * 255).astype(np.uint8) for _ in range(n)]
    labs, cols, degs = mk(), mk(), mk()
    for lab in labs:                      # depth edges for edge_bias
        lab[:, w // 2:] //= 4
    return labs, cols, degs


FEATURES = {
    "plain": {},
    "edge_bias": {"edge_bias": 0.6},
    "scene_weights": {"scene_weights": [0.5, 2.0, 1.0]},
    "collage": {"collage": 0.8},
    "cond": {"cond": [0.25, 0.5, 1.0]},
    "all": {"edge_bias": 0.6, "scene_weights": [1.0, 0.0, 3.0],
            "collage": 0.5, "cond": [0.25, 0.5, 1.0]},
}


@pytest.mark.parametrize("augment", ["full", "flips", "none"])
@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_sample_at_bitwise_with_degraded(feature, augment):
    labs, cols, degs = _imgs()
    kw = dict(scale=4, patch=32, batch=5, seed=7, augment=augment,
              degraded=degs, **FEATURES[feature])
    ours, ref = PatchSampler(labs, cols, **kw), JaxSampler(labs, cols, **kw)
    for step in (0, 1, 5, 123):
        a, b = ours.sample_at(step), ref.sample_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _close_synthesized(a, b):
    for k in ("color", "label", "mask"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    d = np.abs(a["depth"] - b["depth"])
    assert d.max() <= 1.0 / 255 + 1e-6
    assert (d > 0).mean() <= SYN_SHARE


@pytest.mark.parametrize("scale", [4, 8, 16])
def test_sample_at_with_synthesized_degradation(scale):
    labs, cols, _ = _imgs(h=75, w=67, seed=scale)
    kw = dict(scale=scale, patch=32, batch=4, seed=scale, collage=0.5,
              edge_bias=0.5)
    ours, ref = PatchSampler(labs, cols, **kw), JaxSampler(labs, cols, **kw)
    for step in (0, 3):
        _close_synthesized(ours.sample_at(step), ref.sample_at(step))


def test_synthesize_lr_matches_jax():
    labs, _, _ = _imgs(n=1, h=75, w=67)
    for scale in (4, 8, 16):
        a = synthesize_lr(labs[0], scale).astype(np.int64)
        b = jax_synthesize_lr(labs[0], scale).astype(np.int64)
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() <= SYN_SHARE


def test_sample_at_pure_in_step():
    labs, cols, degs = _imgs()
    s = PatchSampler(labs, cols, scale=4, patch=16, batch=4, degraded=degs)
    a1, a2, b = s.sample_at(7), s.sample_at(7), s.sample_at(8)
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k])
    assert not np.array_equal(a1["label"], b["label"])
    s2 = PatchSampler(labs, cols, scale=4, patch=16, batch=4, degraded=degs)
    np.testing.assert_array_equal(s2.sample()["label"],
                                  s.sample_at(0)["label"])


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_stream_position(depth):
    """prefetch(depth, start) delivers sample_at(start), start+1, ...
    whatever the queue depth: the resume contract."""
    labs, cols, degs = _imgs()
    base = PatchSampler(labs, cols, scale=4, patch=16, batch=2,
                        degraded=degs)
    want = [base.sample_at(i)["label"] for i in range(3, 8)]
    pf = base.prefetch(depth, start_step=3)
    try:
        for w in want:
            np.testing.assert_array_equal(pf.sample()["label"], w)
    finally:
        pf.close()
    assert not pf._t.is_alive()


def test_prefetch_propagates_worker_errors():
    """A sampler exception reaches sample(), every time, instead of
    blocking on a queue whose worker died."""
    class Boom(PatchSampler):
        def sample_at(self, step):
            raise ValueError("bad data")

    labs, cols, _ = _imgs(n=1)
    s = Boom(labs, cols, scale=4, patch=16, batch=2).prefetch(2)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="worker thread failed"):
                s.sample()
    finally:
        s.close()


def test_refuses_what_it_does_not_port():
    labs, cols, degs = _imgs(n=1)
    # the pyramid is ported: one level a scale below 1, as JAX's
    s = PatchSampler(labs, cols, patch=16, pyramid=(0.5,), degraded=degs)
    assert len(s._levels) == 2
    with pytest.raises(ValueError, match="smaller than patch"):
        PatchSampler(labs, cols, patch=128, degraded=degs)
    with pytest.raises(ValueError, match="scene_weights"):
        PatchSampler(labs, cols, patch=16, degraded=degs,
                     scene_weights=[-1.0])


PYRAMIDS = {"two": (0.5, 0.75), "with_one": (1.0, 0.6), "small": (0.3,)}


@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_pyramid_levels_match_jax(pyramid):
    """Each level's labels and colors bitwise JAX's, its degraded maps in
    the synthesized class; a scale >= 1 adds no level, and sides stay at
    least `patch`."""
    labs, cols, degs = _imgs(h=75, w=67, seed=4)
    kw = dict(scale=4, patch=32, batch=6, seed=2, degraded=degs,
              pyramid=PYRAMIDS[pyramid])
    ours, ref = PatchSampler(labs, cols, **kw), JaxSampler(labs, cols, **kw)
    assert len(ours._levels) == len(ref._levels) == 1 + sum(
        s < 1 for s in PYRAMIDS[pyramid])
    for k, (a, b) in enumerate(zip(ours._levels, ref._levels)):
        for la, lb in zip(a[0] + a[1], b[0] + b[1]):
            assert min(la.shape) >= 32
            np.testing.assert_array_equal(la, lb)
        for da, db in zip(a[2], b[2]):
            if k == 0:
                np.testing.assert_array_equal(da, db)
                continue
            d = np.abs(da.astype(np.int64) - db.astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= SYN_SHARE


@pytest.mark.parametrize("feature", ["plain", "edge_bias", "all"])
def test_pyramid_patches_match_jax(feature):
    """The level index is drawn where JAX draws it: label and color
    patches bitwise, depth bitwise at level 0 and in the synthesized class
    above it; without augment "full" there is no pyramid, as in JAX."""
    labs, cols, degs = _imgs(h=75, w=67, seed=5)
    kw = dict(scale=4, patch=32, batch=6, seed=9, degraded=degs,
              pyramid=(0.5, 0.75), **FEATURES[feature])
    ours, ref = PatchSampler(labs, cols, **kw), JaxSampler(labs, cols, **kw)
    for step in (0, 1, 17):
        _close_synthesized(ours.sample_at(step), ref.sample_at(step))
    flat = PatchSampler(labs, cols, **dict(kw, augment="flips"))
    assert len(flat._levels) == 1
    jflat = JaxSampler(labs, cols, **dict(kw, augment="flips"))
    for step in (0, 4):
        a, b = flat.sample_at(step), jflat.sample_at(step)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
