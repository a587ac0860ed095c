"""`python -m codon_tpu_torch.cli eval --tile-devices 2 --dp-devices 2` on
the CPU (4 gloo ranks, the cli's own `MeshPool`) against the single-device
eval of the same scale dir, and the mesh's refusals and failures.

The class, and why: the mesh's forward sums its convs and pools in
another order (a shard's rows, the all-reduced statistics), which moves
a bf16 activation by an ulp or an int8 code across a rounding boundary,
and the five recurrent stages carry it. The written PNGs are held in the
static-int8 flip class of tests/test_torch_cli.py carried to uint8, mean
|d| <= 255 x 0.01 + 1 and max <= 255 x 0.1 + 1 levels (the runs here
read mean 0.34, max 8 in bf16 and 0.80, 15 in int8); each image's RMSE
within the RMS of its two PNGs' difference (the triangle inequality on
the same valid pixels) and SSIM within 0.01.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from codon_tpu_torch import cli as tcli
from codon_tpu_torch.data.io import imread_gray
from codon_tpu_torch.kernels import quant as kq
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.parallel import MeshPool, comm, make_tiled_forward
from codon_tpu_torch.parallel.launch import MeshError

from torch_port_common import CKPT_DIR, one_torch_thread, write_scale_dir  # noqa: F401

SIZES = [(34, 29), (21, 30), (26, 19)]
MESH = ["--tile-devices", "2", "--dp-devices", "2"]
PNG_MEAN, PNG_MAX = 255 * 0.01 + 1, 255 * 0.1 + 1


def _eval(data, out, extra, capsys):
    jpath = out + ".json"
    capsys.readouterr()
    rc = tcli.main(["eval", "--scale", "4", "--data-dir", data, "--batch",
                    "2", "--out", out, "--json", jpath, "--device", "cpu",
                    *extra])
    assert rc == 0
    with open(jpath) as f:
        return json.load(f), capsys.readouterr().out


@pytest.mark.parametrize("extra,banner", [
    (["--ckpt", "x4_ship4.npz"], None),
    (["--ckpt", "x4_ship4_qat_static.npz", "--dtype", "int8"],
     "int8: static per-channel scales from checkpoint (18 conv sites)"),
    (["--ckpt", "x4_ship4.npz", "--tta"], "tta: 4-transform"),
    (["--ckpt", "x4_ship4_qat_static.npz", "--dtype", "int8", "--tta8",
      "--device-metrics"], "tta: 8-transform"),
    (["--ckpt", "x4_holdout_sc.npz", "--variant", "codon_sc",
      "--scale-cond", "--dtype", "int8"],
     "scale conditioning: constant channel 0.25"),
], ids=["bf16", "int8-static", "tta", "int8-tta8-device-metrics",
        "codon_sc-int8-dynamic"])
def test_mesh_eval_matches_single_device(tmp_path, capsys, monkeypatch,
                                         extra, banner):
    data = str(tmp_path / "d")
    names = write_scale_dir(data, SIZES, seed=5)
    extra = [os.path.join(CKPT_DIR, a) if a.endswith(".npz") else a
             for a in extra]
    single, _ = _eval(data, str(tmp_path / "one"), extra, capsys)
    # rank 0 is this process: count its int8 convs under the mesh
    calls = []
    composed = kq.composed_int8_conv
    monkeypatch.setattr(kq, "composed_int8_conv",
                        lambda *a, **k: calls.append(1) or composed(*a, **k))
    mesh, said = _eval(data, str(tmp_path / "mesh"), extra + MESH, capsys)
    assert "mesh eval: dp=2 x sp=2 over 4 devices; backend gloo" in said
    if banner:
        assert banner in said
    # the --json summary's tallies: every rank took its blocks, exchanged
    # halo rows, all-reduced its CAC statistics and gave its outputs back
    report = mesh["mesh"]
    assert (report["dp"], report["sp"], report["backend"],
            report["transport"]) == (2, 2, "gloo", "gloo")
    assert len(report["ranks"]) == 4
    for rank, c in enumerate(report["ranks"]):
        for prim in ("scatter", "halo_rows", "all_sum", "all_max", "gather"):
            assert c["comm"][prim]["calls"] > 0, (rank, prim)
            assert c["comm"][prim]["transport"] == ["gloo"], (rank, prim)
    assert "mesh" not in single
    # int8 stays int8 under the mesh (JAX's round-1 bug fell back to bf16)
    assert bool(calls) == ("int8" in extra)
    assert [r["name"] for r in mesh["per_image"]] == names
    assert mesh["tta_transforms"] == single["tta_transforms"]
    for m, s in zip(mesh["per_image"], single["per_image"]):
        a = imread_gray(str(tmp_path / "mesh" / (m["name"] + ".png")))
        b = imread_gray(str(tmp_path / "one" / (m["name"] + ".png")))
        d = np.abs(a.astype(float) - b.astype(float))
        assert d.mean() <= PNG_MEAN and d.max() <= PNG_MAX
        assert abs(m["rmse"] - s["rmse"]) <= np.sqrt((d ** 2).mean()) + 1e-6
        assert m["ssim"] == pytest.approx(s["ssim"], abs=0.01)


def test_mesh_flags_parse():
    args = tcli._build_argparser().parse_args(
        ["eval", "--tile-devices", "4", "--dp-devices", "2",
         "--dist-backend", "gloo"])
    assert (args.tile_devices, args.dp_devices, args.dist_backend) == \
        (4, 2, "gloo")
    args = tcli._build_argparser().parse_args(["eval"])
    assert (args.tile_devices, args.dp_devices, args.dist_backend) == \
        (0, 0, None)


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_nccl_with_too_few_cards_raises(monkeypatch, cards):
    """NCCL takes one card a rank: with fewer cards than ranks it raises,
    naming --dist-backend gloo, and never turns into gloo by itself; gloo
    on CUDA lets the ranks share the cards, rank r on cuda:(r % cards)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        comm.choose_backend("nccl", "cuda", 4)
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        comm.choose_backend(None, "cuda", 4)
    if cards:
        assert comm.choose_backend("gloo", "cuda", 4) == "gloo"
        assert [comm.rank_device(r, "cuda", "gloo").index
                for r in range(4)] == [r % cards for r in range(4)]
    with pytest.raises(ValueError, match="on the CPU the backend is gloo"):
        comm.choose_backend("nccl", "cpu", 4)


def test_cli_nccl_on_the_cpu_raises(tmp_path, capsys):
    data = str(tmp_path / "d")
    write_scale_dir(data, SIZES[:1], seed=6)
    with pytest.raises(ValueError, match="on the CPU the backend is gloo"):
        _eval(data, str(tmp_path / "o"), [*MESH, "--dist-backend", "nccl"],
              capsys)


def test_zoo_under_a_mesh_raises(tmp_path, capsys):
    """The zoo no longer raises under a mesh: `cli eval --variant
    zoo:basenet` over dp=2 x sp=2 writes the single-device eval's PNGs
    within the class, and no rank launches a CAC kernel or calls the CAC
    stage."""
    data = str(tmp_path / "d")
    names = write_scale_dir(data, SIZES, seed=6)
    extra = ["--variant", "zoo:basenet"]
    single, _ = _eval(data, str(tmp_path / "one"), extra, capsys)
    mesh, said = _eval(data, str(tmp_path / "mesh"), extra + MESH, capsys)
    assert "mesh eval: dp=2 x sp=2 over 4 devices; backend gloo" in said
    assert [r["name"] for r in mesh["per_image"]] == names
    for c in mesh["mesh"]["ranks"]:
        assert c["stages"] == {"whole": 0, "shard": 0}
        assert c["comm"]["halo_rows"]["calls"] > 0
    for m, s in zip(mesh["per_image"], single["per_image"]):
        a = imread_gray(str(tmp_path / "mesh" / (m["name"] + ".png")))
        b = imread_gray(str(tmp_path / "one" / (m["name"] + ".png")))
        d = np.abs(a.astype(float) - b.astype(float))
        assert d.mean() <= PNG_MEAN and d.max() <= PNG_MAX
        assert abs(m["rmse"] - s["rmse"]) <= np.sqrt((d ** 2).mean()) + 1e-6


def test_worker_exception_reaches_the_caller():
    """A NaN in the bottom rows fails the bottom rank's first conv under
    the NaN checks; rank 0 (the top rows) then waits on that rank's halo
    rows. The worker's FloatingPointError reaches the caller in seconds,
    the pool closes and its workers are gone."""
    v = get_variant("codon")
    params = v.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(9)
    d = torch.from_numpy(rng.rand(1, 24, 13, 1).astype(np.float32))
    c = torch.from_numpy(rng.rand(1, 24, 13, 1).astype(np.float32))
    d[:, -1] = float("nan")
    pool = MeshPool(2, device="cpu", timeout_s=60)
    try:
        fwd = make_tiled_forward(v, 2, 1, pool=pool, check_nans=True)
        t0 = time.time()
        with pytest.raises(MeshError) as err:
            fwd(params, d, c, None)
        assert time.time() - t0 < 30
        assert "rank 1" in str(err.value)
        assert "FloatingPointError: NaN in the output of conv site " \
               "'input'" in str(err.value)
        assert pool.closed
        assert not any(p.is_alive() for p in pool._procs)
        with pytest.raises(RuntimeError, match="closed"):
            fwd(params, d, c, None)
    finally:
        pool.close()


def test_tiled_infer_starts_and_closes_its_own_pool():
    """Without a mesh, `tiled_infer` starts n_devices gloo ranks for the
    call (on the params' device, the CPU here) and stops them after; its
    answer is the single-device forward's (tests/test_torch_parallel.py's
    float32 tolerance, atol 2e-4 / rtol 1e-3)."""
    import torch.distributed as dist
    from codon_tpu_torch.parallel import tiled_infer
    v = get_variant("codon")
    params = v.init(torch.Generator().manual_seed(1), "cpu")
    rng = np.random.RandomState(10)
    d = rng.rand(1, 21, 13, 1).astype(np.float32)
    c = rng.rand(1, 21, 13, 1).astype(np.float32)
    out = tiled_infer(v, params, d, c, n_devices=2)
    want = v.forward(params, torch.from_numpy(d), torch.from_numpy(c))
    np.testing.assert_allclose(out, want.numpy(), atol=2e-4, rtol=1e-3)
    assert not dist.is_initialized()
