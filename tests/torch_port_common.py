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
