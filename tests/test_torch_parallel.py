"""The port's sharded forward (`codon_tpu_torch.parallel`) against the JAX
package's on its 8-device CPU mesh (tests/conftest.py), and against the
port's own single-device forward; the cases of tests/test_parallel.py.

The port's mesh is 8 gloo ranks on the CPU: this process is rank 0, one
`MeshPool` for the module, its meshes built as the cases ask. Weights are
JAX's random init carried across with `params_from_numpy`; inputs are
numpy from a seed.

Tolerances, and why:
- float32 forwards, sharded against JAX's sharded and against either
  single-device forward: atol 2e-4 / rtol 1e-3, tests/test_parallel.py's
  (the convs of a shard sum in another order than those of the frame).
- the sharded stage against `cac_stage_torch` on the whole tensor, and
  the kernel stage against its plain twin: atol 1e-5 / rtol 1e-5 (one
  stage, the pooled statistics summed shard by shard in float32).
- tile-and-stitch: JAX's bounds, mean |d| < 5e-3 from the whole frame for
  `codon` (its CAC gates pool over a tile) and atol 5e-4 / rtol 1e-3 for
  `rmcr_fuse_rmcr` (no global statistics); against JAX's stitched output,
  max |d| within 1e-4 of the output's largest magnitude: random-init
  `rmcr_fuse_rmcr` reaches |y| = 266 at the case's shape, where the two
  frameworks' whole float32 forwards already differ by 1.2e-5 of it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codon_tpu.parallel.stitch import tile_stitch_infer as jax_stitch
from codon_tpu.parallel.tiling import (make_sharded_forward as jax_sharded,
                                       make_tiled_forward as jax_tiled_fwd,
                                       tiled_infer as jax_tiled)

from codon_tpu_torch.checkpoint.native import params_from_numpy
from codon_tpu_torch.kernels import cac as kc
from codon_tpu_torch.models.codon_net import cac_stage_torch
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import (MeshPool, make_sharded_forward,
                                      make_tiled_forward, tile_stitch_infer,
                                      tiled_infer)
from codon_tpu_torch.parallel.ops import cac_stage_on_shard

from torch_port_common import (cac_mask, cac_towers, cac_weights,  # noqa: F401
                               one_torch_thread, to_np, to_torch)

ATOL, RTOL = 2e-4, 1e-3
STAGE_TOL = 1e-5
STITCH_JAX_FRAC = 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def pool():
    torch.set_num_threads(1)
    p = MeshPool(8, device="cpu", timeout_s=60)
    yield p
    p.close()


def _port_params(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.fixture(scope="module")
def setup():
    jv = jax_variant("codon")
    jparams = jv.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    depth = rng.rand(2, 48, 37, 1).astype(np.float32)
    color = rng.rand(2, 48, 37, 1).astype(np.float32)
    jref = np.asarray(jv.forward(jparams, depth, color))
    v = get_variant("codon")
    params = _port_params(jparams)
    ref = v.forward(params, to_torch(depth), to_torch(color))
    _close(ref, jref)
    return dict(jv=jv, jparams=jparams, v=v, params=params, depth=depth,
                color=color, jref=jref, ref=ref)


def test_pool_ranks(pool):
    assert pool.world == 8 and pool.backend == "gloo"
    assert pool.transport == "gloo"
    with pytest.raises(ValueError, match="needs 9 ranks, only 8"):
        pool.mesh(3, 3)


@pytest.mark.parametrize("n_sp", [2, 4, 8])
def test_tiled_matches_untiled(pool, setup, n_sp):
    s = setup
    out = tiled_infer(s["v"], s["params"], s["depth"], s["color"],
                      mesh=pool.mesh(1, n_sp))
    jout = jax_tiled(s["jv"], s["jparams"], s["depth"], s["color"],
                     n_devices=n_sp)
    _close(out, jout)
    _close(out, s["ref"])
    _close(out, s["jref"])


def test_tiled_with_ragged_height(pool, setup):
    """H = 45 at sp = 8: padded to 48 with zero rows and a zero mask,
    sharded and cropped back."""
    s = setup
    d, c = s["depth"][:, :45], s["color"][:, :45]
    out = tiled_infer(s["v"], s["params"], d, c, mesh=pool.mesh(1, 8))
    assert out.shape == (2, 45, 37, 1)
    jout = jax_tiled(s["jv"], s["jparams"], d, c, mesh=jax_make_mesh([1, 8]))
    _close(out, jout)
    _close(out, s["v"].forward(s["params"], to_torch(d), to_torch(c)))


def test_dp_times_sp_mesh(pool, setup):
    """2-way batch dp x 4-way spatial sp on one mesh."""
    s = setup
    mask = np.ones_like(s["depth"])
    fwd = make_sharded_forward(s["v"], pool.mesh(2, 4))
    out = fwd(s["params"], *(to_torch(a) for a in (s["depth"], s["color"],
                                                   mask)))
    jout = np.asarray(jax_sharded(s["jv"], jax_make_mesh([2, 4]))(
        s["jparams"], s["depth"], s["color"], mask))
    _close(out, jout)
    _close(out, s["ref"])


def test_dp_only_eval(pool, setup):
    s = setup
    out = make_tiled_forward(s["v"], 1, 2, pool=pool)(
        s["params"], to_torch(s["depth"]), to_torch(s["color"]), None)
    jout = np.asarray(jax_tiled_fwd(s["jv"], 1, 2)(
        s["jparams"], s["depth"], s["color"], None))
    _close(out, jout)
    _close(out, s["ref"])


def test_dp_sp_composed_with_batch_padding(pool, setup):
    """dp = 4 with B = 2: two padding images with mask 1, composed with
    sp = 2."""
    s = setup
    out = make_tiled_forward(s["v"], 2, 4, pool=pool)(
        s["params"], to_torch(s["depth"]), to_torch(s["color"]), None)
    assert tuple(out.shape) == s["ref"].shape
    jout = np.asarray(jax_tiled_fwd(s["jv"], 2, 4)(
        s["jparams"], s["depth"], s["color"], None))
    _close(out, jout)
    _close(out, s["ref"])


def test_tiled_masked_mixed_sizes(pool, setup):
    """A padded mixed-size batch, tiled: both exactness mechanisms at
    once."""
    s = setup
    mask = np.zeros_like(s["depth"])
    mask[0] = 1.0
    mask[1, :31, :23] = 1.0
    d, c = s["depth"] * mask, s["color"] * mask
    out = tiled_infer(s["v"], s["params"], d, c, mask=mask,
                      mesh=pool.mesh(1, 4))
    jout = jax_tiled(s["jv"], s["jparams"], d, c, mask=mask, n_devices=4)
    _close(out, jout)
    ref0 = s["v"].forward(s["params"], to_torch(d[:1]), to_torch(c[:1]))
    ref1 = s["v"].forward(s["params"], to_torch(d[1:, :31, :23]),
                          to_torch(c[1:, :31, :23]))
    _close(out[0], ref0[0])
    _close(out[1, :31, :23], ref1[0])


def test_codon_fused_tiled(pool, setup):
    """The merged-tower forward at sp = 2: grouped halo convs, the CAC
    stage on the halves of one tensor."""
    s = setup
    v = get_variant("codon_fused")
    out = tiled_infer(v, s["params"], s["depth"], s["color"],
                      mesh=pool.mesh(1, 2))
    jout = jax_tiled(jax_variant("codon_fused"), s["jparams"], s["depth"],
                     s["color"], n_devices=2)
    _close(out, jout)
    _close(out, s["ref"])


@pytest.mark.parametrize("cac_impl", ["kernel", "torch"])
def test_sharded_path_never_runs_the_unsharded_stage(pool, setup,
                                                     monkeypatch, cac_impl):
    """Under a mesh the kernel stage must pool over every shard:
    `kernels.cac.cac_stage` is never called without the sp group (its
    whole-image form, whose statistics would be one shard's alone; this
    process is rank 0), and is called with it 5 times a forward; the
    plain stage reaches neither. The single-device forward does call the
    whole-image form, so the trap is live."""
    s = setup
    v = dataclasses.replace(s["v"], cfg=dataclasses.replace(
        s["v"].cfg, cac_impl=cac_impl))
    calls = {"whole": 0, "sharded": 0}
    stage = kc.cac_stage

    def counted(*a, group=None, **k):
        calls["whole" if group is None else "sharded"] += 1
        return stage(*a, group=group, **k)

    monkeypatch.setattr(kc, "cac_stage", counted)
    d, c = to_torch(s["depth"]), to_torch(s["color"])
    v.forward(s["params"], d, c)
    assert calls == {"whole": 5 if cac_impl == "kernel" else 0,
                     "sharded": 0}
    calls["whole"] = 0
    out = make_tiled_forward(v, 2, 1, pool=pool)(s["params"], d, c, None)
    assert calls == {"whole": 0,
                     "sharded": 5 if cac_impl == "kernel" else 0}
    _close(out, s["ref"])


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("n_sp", [2, 4])
def test_sharded_stage_matches_whole_tensor(pool, masked, n_sp):
    """One CAC stage on 2 or 4 shards of a (2, 40, 29, 64) tensor: the
    kernel stage (plain versions on the CPU) and its plain twin, each
    against `cac_stage_torch` and `cac_stage` on the whole tensor."""
    rng = np.random.RandomState(3)
    h = 40
    ts = [rng.randn(2, h, 29, 64).astype(np.float32) for _ in range(4)]
    mask = np.ones((2, h, 29, 1), np.float32)
    if masked:
        mask[1, 23:] = 0.0
        mask[1, :, 17:] = 0.0
        ts = [t * mask for t in ts]
    towers = [to_torch(t) for t in ts]
    m = to_torch(mask)
    ws = [to_torch(w) for w in cac_weights(1)]
    want = cac_stage_torch(*towers, *ws, mask=m)
    want_k = kc.cac_stage(*towers, *ws, m)
    mesh = pool.mesh(1, n_sp)
    for impl in ("kernel", "torch"):
        got = pool.shard_map(cac_stage_on_shard, mesh, *towers, m,
                             consts=(*ws, impl))
        for g, w, wk in zip(got, want, want_k):
            _close(g, w, STAGE_TOL, STAGE_TOL)
            _close(g, wk, STAGE_TOL, STAGE_TOL)


def _scaled_close(got, want, frac=STITCH_JAX_FRAC):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    d = float(np.abs(got - want).max())
    assert d <= frac * float(np.abs(want).max()), d


def test_tile_stitch_close_to_whole_frame():
    """Conv stencils exact (halo > receptive field); the divergence comes
    from each tile's own CAC statistics only. 224 rows in tiles of 64 with
    48 rows of halo: four tiles of 160 rows (JAX's case, 160 rows, is one
    padded tile and runs whole)."""
    jv, v = jax_variant("codon"), get_variant("codon")
    jparams = jv.init(jax.random.PRNGKey(2))
    params = _port_params(jparams)
    rng = np.random.RandomState(7)
    base = rng.rand(1, 1, 6, 1).astype(np.float32)
    depth = np.kron(base, np.ones((1, 224, 8, 1), np.float32))
    depth += 0.05 * rng.rand(1, 224, 48, 1).astype(np.float32)
    color = depth * 0.7 + 0.1
    whole = v.forward(params, to_torch(depth), to_torch(color))
    stitched = tile_stitch_infer(v, params, depth, color, tile_h=64,
                                 halo=48)
    assert stitched.shape == tuple(whole.shape)
    diff = np.abs(stitched - to_np(whole))
    assert 0 < diff.mean() < 5e-3, diff.mean()
    _scaled_close(stitched, jax_stitch(jv, jparams, depth, color, tile_h=64,
                                       halo=48))


def test_tile_stitch_attention_free_exact():
    """No CAC gates, no global statistics: tile-and-stitch is exact to
    float noise."""
    jv, v = jax_variant("rmcr_fuse_rmcr"), get_variant("rmcr_fuse_rmcr")
    jparams = jv.init(jax.random.PRNGKey(3))
    params = _port_params(jparams)
    rng = np.random.RandomState(8)
    depth = rng.rand(1, 224, 32, 1).astype(np.float32)
    color = rng.rand(1, 224, 32, 1).astype(np.float32)
    whole = v.forward(params, to_torch(depth), to_torch(color))
    stitched = tile_stitch_infer(v, params, depth, color, tile_h=64,
                                 halo=48)
    _close(stitched, whole, 5e-4, 1e-3)
    _scaled_close(stitched, jax_stitch(jv, jparams, depth, color, tile_h=64,
                                       halo=48))


def test_tile_stitch_short_frame_runs_whole():
    v = get_variant("rmcr_fuse_rmcr")
    params = v.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(9)
    depth = rng.rand(1, 40, 24, 1).astype(np.float32)
    color = rng.rand(1, 40, 24, 1).astype(np.float32)
    whole = v.forward(params, to_torch(depth), to_torch(color))
    got = tile_stitch_infer(v, params, depth, color, tile_h=16, halo=12)
    assert np.array_equal(got, to_np(whole))


def test_sharded_forward_refuses_what_it_cannot_run(pool, setup):
    """Rows a shard must have and shapes the mesh must divide each raise
    on rank 0 before a rank is asked, and the pool stays usable; the zoo
    runs (its sharded forwards are in tests/test_torch_parallel_zoo.py)."""
    s = setup
    fwd = make_sharded_forward(s["v"], pool.mesh(1, 8))
    d = to_torch(s["depth"][:, :8])
    with pytest.raises(ValueError, match="leaves 1 row"):
        fwd(s["params"], d, d, torch.ones_like(d))
    d = to_torch(s["depth"][:, :44])
    with pytest.raises(ValueError, match="must divide"):
        fwd(s["params"], d, d, torch.ones_like(d))
    zv = get_variant("zoo:basenet")
    zp = zv.init(torch.Generator().manual_seed(0), device="cpu")
    d, c = to_torch(s["depth"]), to_torch(s["color"])
    _close(make_tiled_forward(zv, 2, 1, pool=pool)(zp, d, c, None),
           zv.forward(zp, d, c))
    assert not pool.closed
    out = tiled_infer(s["v"], s["params"], s["depth"], s["color"],
                      mesh=pool.mesh(1, 2))
    _close(out, s["ref"])
