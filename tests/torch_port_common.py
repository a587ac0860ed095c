"""Shared helpers of the tests that hold `codon_tpu_torch` against `codon_tpu`.

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU (tests/conftest.py), the port on CPU tensors.
"""
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_DIR = os.path.join(REPO, "checkpoints")


def needs_cuda(fn):
    """Mark a test of the CUDA kernels themselves, which have no CPU mode:
    it runs only where there is a card. The skip condition is a string, so
    it is evaluated when the test runs, not when the module is imported."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card: the CUDA kernels "
                                   "have no CPU mode")(fn)
    return pytest.mark.cuda(fn)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Keep each test's PyTorch to one thread (the suite runs in parallel
    worker processes)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def to_torch(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(device)


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def write_scale_dir(root, sizes, seed=0):
    """A reference-layout scale dir (input_depth/_color/_label) of small
    images, written with the port's own PNG writer. -> sorted names."""
    from codon_tpu_torch.data.io import imwrite_gray
    rng = np.random.RandomState(seed)
    names = []
    for i, (h, w) in enumerate(sizes):
        label = (rng.rand(h, w) * 254 + 1).astype(np.uint8)
        label[rng.rand(h, w) < 0.05] = 0          # invalid depth pixels
        low = label[::4, ::4]
        depth = np.repeat(np.repeat(low, 4, 0), 4, 1)[:h, :w]
        color = (rng.rand(h, w) * 255).astype(np.uint8)
        name = f"img{i}"
        imwrite_gray(os.path.join(root, "input_depth", name + ".png"), depth)
        imwrite_gray(os.path.join(root, "input_color", name + ".png"), color)
        imwrite_gray(os.path.join(root, "input_label", name + ".png"), label)
        names.append(name)
    return sorted(names)


# The CAC-stage shapes of the kernel tests: odd H and W, C = 64.
N, H, W, C = 2, 37, 29, 64
# image 0 fully valid, image 1 valid on its top-left 19 x 15 corner
VALID = [(H, W), (19, 15)]


def cac_mask():
    m = np.zeros((N, H, W, 1), np.float32)
    for i, (h, w) in enumerate(VALID):
        m[i, :h, :w] = 1.0
    return m


def cac_towers(seed, masked):
    """Four (N,H,W,C) towers; with `masked`, zero on padding as masked
    convs leave them."""
    rng = np.random.RandomState(seed)
    ts = [rng.randn(N, H, W, C).astype(np.float32) for _ in range(4)]
    if masked:
        ts = [t * cac_mask() for t in ts]
    return ts


def cac_weights(seed=1):
    rng = np.random.RandomState(seed)
    w1 = rng.uniform(-1, 1, (2 * C, 8)).astype(np.float32) / np.sqrt(2 * C)
    b1 = rng.uniform(-1, 1, (8,)).astype(np.float32) / np.sqrt(2 * C)
    w2 = rng.uniform(-1, 1, (8, C)).astype(np.float32) / np.sqrt(8)
    b2 = rng.uniform(-1, 1, (C,)).astype(np.float32) / np.sqrt(8)
    sp_w = (rng.randn(5, 5, 2, 1) * np.sqrt(2 / 25)).astype(np.float32)
    return w1, b1, w2, b2, sp_w


class RefNet(torch.nn.Module):
    """A stand-in for the reference's pickled model: a module tree whose
    state dict carries the given names ("conv3.weight",
    "attention_c0.mlp.1.weight", ...) and values, and no forward. A `.pth`
    that pickles one needs this class importable to load."""

    def __init__(self, state_dict):
        super().__init__()
        for key, value in state_dict.items():
            *path, leaf = key.split(".")
            mod = self
            for part in path:
                if part not in mod._modules:
                    mod.add_module(part, torch.nn.Module())
                mod = mod._modules[part]
            mod.register_parameter(leaf, torch.nn.Parameter(
                torch.as_tensor(np.asarray(value)), requires_grad=False))


# The zoo tests' two input cases: one unmasked 16 x 13 image, and two
# images padded to 17 x 15 with two valid sizes, masked.
ZOO_CASES = {"unmasked": (1, 16, 13, None),
             "masked": (2, 17, 15, [(17, 15), (11, 9)])}


def zoo_case(case, seed=0):
    """-> (depth, color, mask or None), float32 numpy, of a ZOO_CASES
    case; depth and color are zero on the padding, as the loader leaves
    them."""
    n, h, w, valid = ZOO_CASES[case]
    rng = np.random.RandomState(seed)
    depth = rng.rand(n, h, w, 1).astype(np.float32)
    color = rng.rand(n, h, w, 1).astype(np.float32)
    if valid is None:
        return depth, color, None
    mask = np.zeros((n, h, w, 1), np.float32)
    for i, (vh, vw) in enumerate(valid):
        mask[i, :vh, :vw] = 1.0
    return depth * mask, color * mask, mask


# The custom ops of `codon_tpu_torch.kernels.ops`, each on small inputs
# that the CUDA kernels take too (C = 64 towers, their pitched halves of a
# 2C tensor, 16-channel quant windows): name -> (op name, args).
OP_CASES = ("cac_stats", "cac_stats_unmasked", "cac_stats_pitched",
            "spatial_logits", "cac_apply", "cac_apply_pitched",
            "cac_apply_into_pitched", "quant_im2col_static",
            "quant_im2col_dynamic", "quant_im2col_window", "int8_conv",
            "int8_conv_grouped", "int8_conv_narrow")


def op_case(name, device="cpu", dtype=torch.float32, seed=0):
    """-> (op name in torch.ops.codon, args) of one OP_CASES case."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, dt=dtype, scale=1.0):
        t = torch.randn(shape, generator=g) * scale
        return t.to(device=device, dtype=dt)

    def rand_int8(*shape):
        return torch.randint(-127, 128, shape, generator=g,
                             dtype=torch.int8).to(device)

    n, h, w = 2, 9, 7
    mask = torch.ones((n, h, w, 1))
    mask[1, 5:] = 0
    mask = mask.to(device=device, dtype=dtype)
    towers = [rand(n, h, w, C) * mask for _ in range(4)]
    wide = [rand(n, h, w, 2 * C) * mask for _ in range(2)]
    halves = [wide[0][..., :C], wide[0][..., C:], wide[1][..., :C],
              wide[1][..., C:]]
    gate = torch.rand((n, 1, C), generator=g).to(device)
    logits = rand(n, h, w)
    x = rand(n, h, w, 32, scale=3.0)
    sc = (torch.rand(32, generator=g) * 0.05 + 0.01).to(device)
    sx = (torch.rand(n, generator=g) * 0.05 + 0.01).to(device)
    sw = (torch.rand(32, generator=g) * 1e-3).to(device)
    cases = {
        "cac_stats": ("cac_stats", (towers[0], towers[1], mask)),
        "cac_stats_unmasked": ("cac_stats", (towers[0], towers[1], None)),
        "cac_stats_pitched": ("cac_stats", (halves[0], halves[1], mask)),
        "spatial_logits": ("spatial_logits",
                           (rand(n, h, w), rand(n, h, w),
                            rand(5, 5, 2, 1, dt=torch.float32))),
        "cac_apply": ("cac_apply", (*towers, gate, logits)),
        "cac_apply_pitched": ("cac_apply", (*halves, gate, logits)),
        "cac_apply_into_pitched": (
            "cac_apply_into",
            (*halves, gate, logits,
             *(lambda t: (t[..., :C], t[..., C:]))(
                 torch.zeros((n, h, w, 2 * C), dtype=dtype,
                             device=device)))),
        "quant_im2col_static": ("quant_im2col", (x, 3, sc, None, 0, None)),
        "quant_im2col_dynamic": ("quant_im2col", (x, 1, None, sx, 0, None)),
        "quant_im2col_window": ("quant_im2col",
                                (rand_int8(n, h, w, 32), 5, None, None, 16,
                                 16)),
        "int8_conv": ("int8_conv", (x, rand_int8(3, 3, 32, 32), sw, dtype,
                                    sc, None, mask, 1)),
        "int8_conv_grouped": ("int8_conv",
                              (rand_int8(n, h, w, 32),
                               rand_int8(5, 5, 16, 32), sw, dtype, None,
                               None, mask, 2)),
        # a zoo-like narrow site: 8 input channels a group, zero-padded
        "int8_conv_narrow": ("int8_conv",
                             (x, rand_int8(1, 1, 8, 32), sw, dtype, None,
                              sx, None, 4)),
    }
    return cases[name]
