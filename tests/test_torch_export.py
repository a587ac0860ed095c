"""The port's serving artifacts (`codon_tpu_torch.serve`) against the JAX
package's (`codon_tpu.serve`), on the CPU, and against the port's own live
forward.

Each of tests/test_export.py's four cases is mirrored: the same numpy
inputs and parameters (JAX's init, halved, carried across with
`params_from_numpy`; for int8 JAX's calibrated `act_scales` as numpy) go
through JAX's `export_forward` -> `load_exported` and the port's, traced
at batch 2 and called at batches 1 and 3. Tolerances, and why:
- port artifact against JAX artifact, float32 (plain and TTA8): 5e-4 abs,
  the model-parity bound (the two frameworks sum in other orders);
- int8 static (with mask, with TTA4): the flip class of
  tests/test_torch_quant.py, mean |d| <= 0.01, max <= 0.1 (one int8 code
  that flips at a rounding boundary cascades through the stages);
- port artifact against the port's live forward: bitwise, in float32,
  bfloat16 and int8. The variants run `cac_impl="kernel"`, so the CAC
  stage is in the program as the custom ops, as on the card; on the CPU
  the ops run their plain versions, as the live forward's wrappers do.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from codon_tpu.models.variants import get_variant as jax_variant
from codon_tpu.quant_ops import Int8StaticOps as JaxInt8StaticOps
from codon_tpu.quant_ops import calibrate_act_scales as jax_calibrate
from codon_tpu.serve import export_forward as jax_export
from codon_tpu.serve import load_exported as jax_load

from codon_tpu_torch import quant_ops as tq
from codon_tpu_torch.checkpoint.native import load_npz, params_from_numpy
from codon_tpu_torch.core.params import BF16, FP32
from codon_tpu_torch.kernels import cac as kc
from codon_tpu_torch.kernels import quant as kq
from codon_tpu_torch.models.tta import make_tta_forward
from codon_tpu_torch.models.variants import get_variant
from codon_tpu_torch.serve import export_forward, load_exported
from codon_tpu_torch.serve.export import META

from torch_port_common import (CKPT_DIR, OP_CASES, REPO,  # noqa: F401
                               one_torch_thread, op_case, to_torch)

HW = (20, 17)
FP32_TOL = 5e-4
FLIP_CLASS = (0.01, 0.1)
CAC_OPS = ("cac_stats", "spatial_logits", "cac_apply")
# the quantized conv calls and handoffs of one static-int8 codon forward
INT8_CONV_CALLS, INT8_HANDOFFS = 43, 26


def kernel_variant(name="codon", dtypes=FP32):
    v = get_variant(name, dtypes)
    return dataclasses.replace(v, cfg=dataclasses.replace(v.cfg,
                                                          cac_impl="kernel"))


def jax_params(seed, name="codon"):
    v = jax_variant(name)
    return jax.tree.map(lambda w: np.asarray(w) * 0.5,
                        v.init(jax.random.PRNGKey(seed)))


def codon_nodes(path):
    """-> {op name: calls} of the codon:: custom ops in an artifact."""
    program = torch.export.load(path)
    return collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if str(n.target).startswith("codon."))


def inputs(rng, b, masked=False):
    d = rng.rand(b, *HW, 1).astype(np.float32)
    c = rng.rand(b, *HW, 1).astype(np.float32)
    if not masked:
        return d, c
    m = np.ones_like(d)
    m[-1, 14:] = 0.0                 # the last image padded
    return d * m, c * m, m


def assert_flip_class(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.mean() <= FLIP_CLASS[0] and diff.max() <= FLIP_CLASS[1], (
        diff.mean(), diff.max())


def count_int8_convs(monkeypatch):
    """Count the live forward's `int8_conv` calls (quant_ops' name)."""
    calls = collections.Counter()
    real = tq.int8_conv

    def counted(*args, **kw):
        calls["int8_conv"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tq, "int8_conv", counted)
    return calls


@pytest.fixture(scope="module")
def fp32_artifact(tmp_path_factory):
    """codon fp32 (JAX's init of key 0, halved) exported by the port."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jp = jax_params(0)
        tv = kernel_variant()
        tp = params_from_numpy(jp, "cpu")
        path = str(tmp_path_factory.mktemp("fp32") / "m.pt2")
        n = export_forward(tv, tp, HW, path)
    finally:
        torch.set_num_threads(saved)
    return jp, tv, tp, path, n


def test_export_roundtrip_polymorphic_batch(fp32_artifact, tmp_path):
    jp, tv, tp, path, n = fp32_artifact
    assert n > 0
    assert codon_nodes(path) == {op: 5 for op in CAC_OPS}
    jpath = str(tmp_path / "m.codonx")
    jax_export(jax_variant("codon"), jp, HW, jpath)
    jfn, tfn = jax_load(jpath), load_exported(path, "cpu")
    assert tfn.meta == {"platform": "cpu", "height": 20, "width": 17,
                        "dtype": "float32", "ops": None, "tta": 0,
                        "mask": False, "scale_cond": None,
                        "variant": "codon", "torch": torch.__version__,
                        "tf32": False}
    rng = np.random.RandomState(0)
    for b in (1, 3):   # one artifact, any batch
        d, c = inputs(rng, b)
        got = tfn(d, c)
        assert got.shape == (b, *HW, 1) and got.dtype == torch.float32
        assert torch.equal(got, tv.forward(tp, to_torch(d), to_torch(c)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(d, c)),
                                   atol=FP32_TOL, rtol=0)


def test_export_tta_int8(tmp_path, monkeypatch):
    """TTA4 over static int8 with the mask input: JAX's calibrated scales,
    the int8 convs as codon::int8_conv nodes, as many as the live forward
    calls, the handoffs as codon::quant_im2col."""
    jv, jp = jax_variant("codon"), jax_params(2)
    rng = np.random.RandomState(2)
    d, c, m = inputs(rng, 2, masked=True)
    scales = jax_calibrate(
        lambda p, a, b, ops, mask: jv.forward(p, a, b, ops=ops, mask=mask),
        jp, [(d, c, m)])
    jpath, tpath = str(tmp_path / "m.codonx"), str(tmp_path / "m.pt2")
    jax_export(jv, jp, HW, jpath, ops=JaxInt8StaticOps(scales), mask=True,
               tta=True)
    tv, tp = kernel_variant(), params_from_numpy(jp, "cpu")
    ops = tq.Int8StaticOps({k: np.asarray(v) for k, v in scales.items()})
    export_forward(tv, tp, HW, tpath, ops=ops, mask=True, tta=True)
    live = make_tta_forward(
        lambda p, a, b, mk: tv.forward(p, a, b, mask=mk, ops=ops))
    jfn, tfn = jax_load(jpath), load_exported(tpath, "cpu")
    calls = count_int8_convs(monkeypatch)
    for b in (1, 3):
        d, c, m = inputs(rng, b, masked=True)
        calls.clear()
        want = live(tp, to_torch(d), to_torch(c), to_torch(m))
        got = tfn(d, c, m)
        assert torch.equal(got, want)
        assert_flip_class(got.numpy(), jfn(d, c, m))
    assert calls["int8_conv"] == INT8_CONV_CALLS    # one batched forward
    assert codon_nodes(tpath) == {**{op: 5 for op in CAC_OPS},
                                  "int8_conv": INT8_CONV_CALLS,
                                  "quant_im2col": INT8_HANDOFFS}


def test_export_tta8_polymorphic_batch(tmp_path):
    """TTA8: the transposed quartet's second forward at (W, H) inside the
    one artifact, 10 launches of each CAC op."""
    jv, jp = jax_variant("codon"), jax_params(3)
    jpath, tpath = str(tmp_path / "m.codonx"), str(tmp_path / "m.pt2")
    jax_export(jv, jp, HW, jpath, tta=8)
    tv, tp = kernel_variant(), params_from_numpy(jp, "cpu")
    export_forward(tv, tp, HW, tpath, tta=8)
    assert codon_nodes(tpath) == {op: 10 for op in CAC_OPS}
    live = make_tta_forward(lambda p, a, b, mk: tv.forward(p, a, b, mask=mk),
                            transforms=8)
    jfn, tfn = jax_load(jpath), load_exported(tpath, "cpu")
    rng = np.random.RandomState(3)
    for b in (1, 3):
        d, c = inputs(rng, b)
        got = tfn(d, c)
        assert torch.equal(got, live(tp, to_torch(d), to_torch(c), None))
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(d, c)),
                                   atol=FP32_TOL, rtol=0)


def test_export_int8_static_and_mask(tmp_path, monkeypatch):
    jv, jp = jax_variant("codon"), jax_params(1)
    rng = np.random.RandomState(1)
    d, c, m = inputs(rng, 2, masked=True)
    scales = jax_calibrate(
        lambda p, a, b, ops, mask: jv.forward(p, a, b, ops=ops, mask=mask),
        jp, [(d, c, m)])
    jpath, tpath = str(tmp_path / "m8.codonx"), str(tmp_path / "m8.pt2")
    jax_export(jv, jp, HW, jpath, ops=JaxInt8StaticOps(scales), mask=True)
    tv, tp = kernel_variant(), params_from_numpy(jp, "cpu")
    ops = tq.Int8StaticOps({k: np.asarray(v) for k, v in scales.items()})
    export_forward(tv, tp, HW, tpath, ops=ops, mask=True)
    assert load_exported(tpath, "cpu").meta["ops"] == "Int8StaticOps"
    jfn, tfn = jax_load(jpath), load_exported(tpath, "cpu")
    calls = count_int8_convs(monkeypatch)
    for b in (1, 3):
        d, c, m = inputs(rng, b, masked=True)
        calls.clear()
        want = tv.forward(tp, to_torch(d), to_torch(c), mask=to_torch(m),
                          ops=ops)
        got = tfn(d, c, m)
        assert torch.equal(got, want)
        assert_flip_class(got.numpy(), jfn(d, c, m))
    nodes = codon_nodes(tpath)
    assert nodes["int8_conv"] == calls["int8_conv"] == INT8_CONV_CALLS
    assert nodes["quant_im2col"] == INT8_HANDOFFS


def test_export_bf16_with_mask_equals_live(tmp_path):
    jp = jax_params(4)
    tv, tp = kernel_variant(dtypes=BF16), params_from_numpy(jp, "cpu")
    path = str(tmp_path / "bf16.pt2")
    export_forward(tv, tp, HW, path, mask=True)
    fn = load_exported(path, "cpu")
    assert fn.meta["dtype"] == "bfloat16" and fn.meta["mask"]
    rng = np.random.RandomState(4)
    for b in (1, 3):
        d, c, m = inputs(rng, b, masked=True)
        want = tv.forward(tp, to_torch(d), to_torch(c), mask=to_torch(m))
        assert torch.equal(fn(to_torch(d), to_torch(c), to_torch(m)), want)


def test_int8_conv_keeps_a_symbolic_batch():
    """Regression: `int8_conv` loops over a batch's image blocks in Python,
    which fixed the traced batch ("marked b as dynamic but your code
    specialized it to be a constant (2)"); as one custom op it does not.
    Traced at batch 2, run at 1 and 3."""
    g = torch.Generator().manual_seed(0)
    w8 = torch.randint(-127, 128, (3, 3, 32, 64), generator=g,
                       dtype=torch.int8)
    sw = torch.rand(64, generator=g) * 1e-3
    sc = torch.rand(32, generator=g) * 0.05 + 0.01

    class Conv(torch.nn.Module):
        def forward(self, x, m):
            return kq.int8_conv(x, w8, sw, torch.float32, sc=sc, mask=m)

    x = torch.randn((2, 9, 7, 32), generator=g)
    m = torch.ones((2, 9, 7, 1))
    b = torch.export.Dim("b")
    program = torch.export.export(Conv(), (x, m), dynamic_shapes=(
        {0: b}, {0: b}), strict=False)
    for n in (1, 3):
        x = torch.randn((n, 9, 7, 32), generator=g)
        m = torch.ones((n, 9, 7, 1))
        assert torch.equal(program.module()(x, m), Conv()(x, m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", OP_CASES)
def test_custom_ops_pass_opcheck(case, dtype):
    """Schema, fake implementation (shapes, dtypes, strides with a symbolic
    batch) and the real one agree, as torch.library.opcheck tests them."""
    op, args = op_case(case, dtype=dtype)
    result = torch.library.opcheck(getattr(torch.ops.codon, op), args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("variant", ["codon_fused", "rmcr_fuse_rmcr"])
def test_other_forwards_export_bitwise(variant, tmp_path):
    """The merged-tower forward writes the next T through
    codon::cac_apply_into on its halves; the sequential one has no CAC."""
    jp = jax_params(5)
    tv, tp = kernel_variant(variant), params_from_numpy(jp, "cpu")
    path = str(tmp_path / "m.pt2")
    export_forward(tv, tp, HW, path, mask=True)
    want_nodes = ({"cac_stats": 5, "spatial_logits": 5, "cac_apply_into": 5}
                  if variant == "codon_fused" else {})
    assert codon_nodes(path) == want_nodes
    fn = load_exported(path, "cpu")
    rng = np.random.RandomState(5)
    for b in (1, 3):
        d, c, m = inputs(rng, b, masked=True)
        want = tv.forward(tp, to_torch(d), to_torch(c), mask=to_torch(m))
        assert torch.equal(fn(d, c, m), want)


_SERVE = r"""
import sys
for name in ("codon_tpu_torch.models", "codon_tpu_torch.quant_ops",
             "codon_tpu_torch.cli", "jax", "codon_tpu", "cv2", "PIL"):
    sys.modules[name] = None          # any import of these now raises
import numpy as np, torch
torch.set_num_threads(1)
from codon_tpu_torch.serve import load_exported
fn = load_exported(sys.argv[1], "cpu")
d, c = np.load(sys.argv[2]), np.load(sys.argv[3])
np.save(sys.argv[4], fn(d, c).numpy())
assert not [m for m, mod in sys.modules.items()
            if mod is not None and m.startswith("codon_tpu_torch.models")]
print("ok")
"""


def test_loader_needs_no_model_code(fp32_artifact, tmp_path):
    """A serving process that cannot import the model code (nor jax,
    codon_tpu, cv2, PIL) loads the artifact and answers a request."""
    _, tv, tp, path, _ = fp32_artifact
    d, c = inputs(np.random.RandomState(6), 2)
    files = [str(tmp_path / f) for f in ("d.npy", "c.npy", "out.npy")]
    np.save(files[0], d)
    np.save(files[1], c)
    res = subprocess.run([sys.executable, "-c", _SERVE, path, *files],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    want = tv.forward(tp, to_torch(d), to_torch(c))
    assert torch.equal(torch.from_numpy(np.load(files[2])), want)


def test_loader_refuses_another_platform(fp32_artifact, tmp_path):
    """As jax.export refuses a cross-platform call: an artifact recorded
    for the card does not run on the CPU, and a program without the record
    is not taken."""
    path = fp32_artifact[3]
    extra = {META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    cuda = str(tmp_path / "cuda.pt2")
    torch.export.save(program, cuda, extra_files={
        META: json.dumps({**meta, "platform": "cuda"})})
    with pytest.raises(ValueError, match="platform 'cuda'"):
        load_exported(cuda, "cpu")
    bare = str(tmp_path / "bare.pt2")
    torch.export.save(program, bare)
    with pytest.raises(ValueError, match=META):
        load_exported(bare, "cpu")
    if not torch.cuda.is_available():
        # the default device is the card, and there is none here
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_exported(path)


def test_live_forward_through_the_ops_counts_as_before(monkeypatch):
    """A live static-int8 eval forward dispatches each kernel launch as a
    codon:: op, and on the CPU each op runs its plain version once: 5 of
    each CAC op, 43 int8 convs (one image block each here) whose quantize-
    gathers, GEMMs and epilogues are 43 plain calls each, and 26 handoff
    quantizes; the CUDA launch counters stay where they were."""
    from torch.utils._python_dispatch import TorchDispatchMode

    plain = collections.Counter()
    for mod, name in ((kc, "cac_stats_plain"), (kc, "spatial_logits_plain"),
                      (kc, "cac_apply_plain"), (kq, "quant_im2col_plain"),
                      (kq, "dequant_epilogue_plain"), (kq, "int8_gemm")):
        real = getattr(mod, name)

        def counted(*args, _real=real, _name=name, **kw):
            plain[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, counted)

    ops = collections.Counter()

    class CountOps(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "codon":
                ops[func._opname] += 1
            return func(*args, **(kwargs or {}))

    tree = load_npz(os.path.join(CKPT_DIR, "x4_ship4_qat_static.npz"))
    ops_int8 = tq.Int8StaticOps(tree.pop("act_scales"))
    tv, tp = kernel_variant(), params_from_numpy(tree, "cpu")
    d, c, m = inputs(np.random.RandomState(7), 2, masked=True)
    before = {**kc.launches(), **kq.launches()}
    with CountOps():
        tv.forward(tp, to_torch(d), to_torch(c), mask=to_torch(m),
                   ops=ops_int8)
    assert {**kc.launches(), **kq.launches()} == before
    assert ops == {"cac_stats": 5, "spatial_logits": 5, "cac_apply": 5,
                   "int8_conv": INT8_CONV_CALLS,
                   "quant_im2col": INT8_HANDOFFS}
    assert plain == {"cac_stats_plain": 5, "spatial_logits_plain": 5,
                     "cac_apply_plain": 5,
                     "quant_im2col_plain": INT8_CONV_CALLS + INT8_HANDOFFS,
                     "dequant_epilogue_plain": INT8_CONV_CALLS,
                     "int8_gemm": INT8_CONV_CALLS}
