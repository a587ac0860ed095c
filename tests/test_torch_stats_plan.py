"""cac_stats' chunk map, `kernels.cac.StatsPlan`, on the CPU.

The CUDA kernel (csrc/cac.cu `cac_stats_kernel`) cuts each image into
chunks of whole rows, writes each chunk's per-channel partials to a slot of
its own, and lets the block that finishes an image add that image's slots
in a fixed order. `StatsPlan` mirrors the map and the order. These tests
hold the mirror: every pixel in exactly one chunk, the slots and the order
the same for any grid and, for an image, in a batch of up to 4; and the
plain version's per-chunk partials, added in the mirror's order, equal to
`cac_stats_plain` and to the JAX package's Pallas kernel (interpret mode)
within the float32 tolerance of tests/test_kernels.py (atol 1e-5, rtol
1e-4; sums compared as means). The kernel itself is held against the plain
version on a card, in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from codon_tpu.kernels import cac as jcac

from codon_tpu_torch.kernels import cac as tcac

from torch_port_common import one_torch_thread, to_torch  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4
# (N, H, W): the b4 eval, both TTA8 batches, the training step, an odd
# frame, one pixel, a frame below one chunk, a tall narrow one, a ragged one
SHAPES = [(4, 384, 480), (16, 384, 480), (16, 480, 384), (16, 64, 64),
          (2, 37, 29), (3, 1, 1), (2, 3, 5), (1, 300, 2), (5, 130, 7)]
SHAPE_IDS = ["eval", "tta8", "tta8_t", "train", "37x29", "1x1",
             "below-a-chunk", "tall", "ragged"]
# blocks of a grid: one, a few, the H100's 132 SMs times 1, 2 and 4
GRIDS = [1, 7, 132, 264, 528]


def walk(plan, grid):
    """The kernel's persistent grid, block b taking chunks b, b + grid, ...:
    -> {slot: chunk} for every chunk it writes."""
    slots = {}
    for b in range(min(grid, plan.chunks)):
        for i in range(b, plan.chunks, grid):
            assert i not in slots
            slots[i] = plan.chunk(i)
    return slots


def image_order(plan, n, c):
    """The slots the block finishing image n adds, group by group."""
    return [[n * plan.per_image + k for k in group]
            for group in plan.reduce_groups(c)]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_chunks_cover_every_pixel_once(shape):
    n, h, w = shape
    plan = tcac.stats_plan(n, h, w)
    seen = np.zeros((n, h * w), np.int64)
    for i in range(plan.chunks):
        img, first, count = plan.chunk(i)
        assert first % w == 0 and count % w == 0     # whole rows
        seen[img, first:first + count] += 1
    assert (seen == 1).all()
    assert plan.per_image <= tcac.STATS_MAX_CHUNKS
    for k in range(plan.per_image - 1):     # all but an image's last chunk
        assert plan.chunk(k)[2] >= min(tcac.STATS_MIN_PIXELS, h * w)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_slots_and_order_do_not_depend_on_the_grid(shape):
    plan = tcac.stats_plan(*shape)
    want = {i: plan.chunk(i) for i in range(plan.chunks)}
    for grid in GRIDS + [plan.chunks + 3]:
        assert walk(plan, grid) == want
    # the order of an image's sum is read off the plan alone
    for c in (16, 64, 256):
        order = image_order(plan, shape[0] - 1, c)
        assert sorted(k for g in order for k in g) == list(
            range((shape[0] - 1) * plan.per_image, shape[0] * plan.per_image))
        assert len(order) == tcac.STATS_THREADS // c


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_an_image_keeps_its_chunks_in_a_batch_of_up_to_4(shape):
    """About STATS_TARGET_CHUNKS chunks a call: up to 4 images a call every
    image gets the most chunks, STATS_MAX_CHUNKS, so an image's chunks
    (and its sums' order) are the same alone and in the b4 eval's batch."""
    _, h, w = shape
    alone = tcac.stats_plan(1, h, w)
    for n in (1, 2, 3, 4, 16, 64):
        plan = tcac.stats_plan(n, h, w)
        assert plan.per_image <= max(1, min(
            tcac.STATS_MAX_CHUNKS, -(-tcac.STATS_TARGET_CHUNKS // n)))
        if n > 4:
            continue
        assert plan.rows == alone.rows
        for img in range(n):
            got = [plan.chunk(img * plan.per_image + k)
                   for k in range(plan.per_image)]
            assert got == [(img, *alone.chunk(k)[1:])
                           for k in range(alone.per_image)]


@pytest.mark.parametrize("shape,rows,per_image", [
    ((4, 384, 480), 6, 64), ((16, 384, 480), 24, 16),
    ((16, 480, 384), 30, 16), ((16, 64, 64), 4, 16), ((2, 37, 29), 9, 5),
    ((3, 1, 1), 256, 1), ((2, 3, 5), 52, 1)],
    ids=["eval", "tta8", "tta8_t", "train", "37x29", "1x1",
         "below-a-chunk"])
def test_plan_at_the_ports_shapes(shape, rows, per_image):
    plan = tcac.stats_plan(*shape)
    assert (plan.rows, plan.per_image) == (rows, per_image)
    assert plan.chunks == shape[0] * per_image


def _mirror_stats(x, y, mask, plan, c):
    """The plain version on each chunk alone, its partials added in the
    mirror's order, float32 throughout -> (ch_sum, ch_max) (N, 1, 2C)."""
    n, h, w, _ = x.shape
    flat = [t.reshape(n, 1, h * w, -1) for t in (x, y)]
    m = None if mask is None else mask.reshape(n, 1, h * w, 1)
    sums, maxes = [], []
    for i in range(plan.chunks):
        img, first, count = plan.chunk(i)
        part = [t[img:img + 1, :, first:first + count] for t in flat]
        pm = None if m is None else m[img:img + 1, :, first:first + count]
        s, mx, _, _ = tcac.cac_stats_plain(*part, pm)
        sums.append(s.numpy()[0, 0])
        maxes.append(mx.numpy()[0, 0])
    ch_sum = np.zeros((n, 1, 2 * c), np.float32)
    ch_max = np.zeros((n, 1, 2 * c), np.float32)
    for img in range(n):
        total = np.zeros(2 * c, np.float32)
        top = np.full(2 * c, tcac.NEG, np.float32)
        for group in image_order(plan, img, c):
            acc = np.zeros(2 * c, np.float32)
            for k in group:
                acc = acc + sums[k]
                top = np.maximum(top, maxes[k])
            total = total + acc
        ch_sum[img, 0], ch_max[img, 0] = total, top
    return ch_sum, ch_max


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("shape", [(2, 37, 29, 64), (3, 70, 45, 16),
                                   (2, 64, 64, 32), (3, 1, 1, 16),
                                   (2, 3, 5, 64)],
                         ids=["37x29", "70x45", "train-like", "1x1",
                              "below-a-chunk"])
def test_mirror_order_sum_matches_plain_and_pallas(shape, masked):
    n, h, w, c = shape
    rng = np.random.RandomState(sum(shape))
    mask = np.zeros((n, h, w, 1), np.float32)
    mask[:, :max(1, h - h // 3), :max(1, w - w // 4)] = 1.0
    x, y = (rng.randn(*shape).astype(np.float32) * mask for _ in range(2))
    m = mask if masked else None
    plan = tcac.stats_plan(n, h, w)
    got_sum, got_max = _mirror_stats(
        to_torch(x), to_torch(y), None if m is None else to_torch(m), plan, c)
    plain = tcac.cac_stats_plain(to_torch(x), to_torch(y),
                                 None if m is None else to_torch(m))
    pallas = jcac.cac_stats(jnp.asarray(x), jnp.asarray(y),
                            None if m is None else jnp.asarray(m),
                            interpret=True)
    for want_sum, want_max in ((plain[0].numpy(), plain[1].numpy()),
                               (np.asarray(pallas[0]),
                                np.asarray(pallas[1]))):
        np.testing.assert_allclose(got_sum / (h * w), want_sum / (h * w),
                                   atol=ATOL, rtol=RTOL)
        # a max takes no order: the same bits
        np.testing.assert_array_equal(got_max, want_max)
