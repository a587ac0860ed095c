"""The port's reader of the reference's `.pth` checkpoints
(`codon_tpu_torch.checkpoint.torch_convert`) against
`codon_tpu.checkpoint.torch_convert`, on state dicts and `.pth` files the
tests write themselves (the release's files are not in the repo). Arrays
are compared exactly: both sides only transpose and stack."""
import os

import numpy as np
import pytest
import torch

import jax

from codon_tpu.checkpoint import torch_convert as jtc
from codon_tpu.checkpoint.native import load_npz as jax_load_npz
from codon_tpu.models.codon_net import CodonConfig as JConfig

from codon_tpu_torch.checkpoint import torch_convert as ttc
from codon_tpu_torch.checkpoint.native import load_npz
from codon_tpu_torch.models.codon_net import CodonConfig

from torch_port_common import CKPT_DIR, RefNet, one_torch_thread  # noqa: F401

SHIP = os.path.join(CKPT_DIR, "x4_ship4.npz")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_tree(got, want):
    got, want = _np_tree(got), _np_tree(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w)


def _state_dict(dead_heads=True, prefix=False, dtype=np.float32):
    """x4_ship4.npz under the reference's names, by the JAX converter."""
    sd = jtc.params_to_torch_state_dict(
        jax_load_npz(SHIP), JConfig(dead_heads=dead_heads),
        module_prefix=prefix)
    return {k: np.ascontiguousarray(v).astype(dtype) for k, v in sd.items()}


@pytest.mark.parametrize("dead_heads", [True, False],
                         ids=["dead-heads", "no-dead-heads"])
@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "module"])
def test_state_dict_to_params_matches_jax(dead_heads, prefix):
    sd = _state_dict(prefix=prefix)
    want = jtc.torch_state_dict_to_params(sd, JConfig(dead_heads=dead_heads))
    got = ttc.torch_state_dict_to_params(sd,
                                         CodonConfig(dead_heads=dead_heads))
    _assert_same_tree(got, want)
    assert ("attention_c5" in got) == dead_heads


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "module"])
def test_params_to_state_dict_matches_jax(prefix):
    cfg = CodonConfig(dead_heads=True)
    want = jtc.params_to_torch_state_dict(jax_load_npz(SHIP),
                                          JConfig(dead_heads=True), prefix)
    got = ttc.params_to_torch_state_dict(load_npz(SHIP), cfg, prefix)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    # and back: the round trip gives the checkpoint's tree
    _assert_same_tree(ttc.torch_state_dict_to_params(got, cfg),
                      load_npz(SHIP))


def test_attention_free_config_drops_the_cac_heads():
    sd = _state_dict()
    cfg = CodonConfig(use_cac=False)
    got = ttc.torch_state_dict_to_params(sd, cfg)
    want = jtc.torch_state_dict_to_params(sd, JConfig(use_cac=False))
    _assert_same_tree(got, want)
    assert "cac" not in got


def _write_pth(path, kind):
    """One of the forms the reference's `.pth` files take."""
    tensors = lambda sd: {k: torch.from_numpy(v)  # noqa: E731
                          for k, v in sd.items()}
    if kind == "state-dict":
        obj = tensors(_state_dict())
    elif kind == "epoch-model-module-prefix":
        obj = {"epoch": 41, "model": tensors(_state_dict(prefix=True))}
    elif kind == "epoch-full-module":
        obj = {"epoch": 7, "model": RefNet(_state_dict())}
    elif kind == "full-module":
        obj = RefNet(_state_dict())
    elif kind == "fp16":
        obj = {"epoch": 3, "model": RefNet(_state_dict(dtype=np.float16))}
    torch.save(obj, path)


PTH_KINDS = ["state-dict", "epoch-model-module-prefix", "epoch-full-module",
             "full-module", "fp16"]


@pytest.mark.parametrize("kind", PTH_KINDS)
@pytest.mark.parametrize("dead_heads", [True, False],
                         ids=["dead-heads", "no-dead-heads"])
def test_load_pth_matches_jax(tmp_path, kind, dead_heads):
    path = str(tmp_path / "m.pth")
    _write_pth(path, kind)
    want, want_epoch = jtc.load_pth(path, JConfig(dead_heads=dead_heads))
    got, epoch = ttc.load_pth(path, CodonConfig(dead_heads=dead_heads))
    assert epoch == want_epoch == {"state-dict": -1,
                                   "epoch-model-module-prefix": 41,
                                   "epoch-full-module": 7,
                                   "full-module": -1, "fp16": 3}[kind]
    _assert_same_tree(got, want)
    dt = np.float16 if kind == "fp16" else np.float32
    assert got["conv3"].dtype == dt and got["conv3"].shape == (5, 5, 128, 128)


def test_load_pth_of_the_checkpoint_gives_the_checkpoint(tmp_path):
    path = str(tmp_path / "m.pth")
    _write_pth(path, "epoch-model-module-prefix")
    got, _ = ttc.load_pth(path, CodonConfig(dead_heads=True))
    _assert_same_tree(got, load_npz(SHIP))
