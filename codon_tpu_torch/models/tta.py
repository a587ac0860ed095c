"""Geometric self-ensemble (test-time augmentation) for depth SR.

The counterpart of `codon_tpu.models.tta`. The model is averaged over a
group of geometric transforms, each prediction mapped back. The default is
the 4 flips (id / V / H / HV): flips keep (H, W), so the four copies ride
one forward on the batch axis, and masks flip with the content, so padded
mixed-size batches stay exact. transforms=8 is the full dihedral group D4:
the transposed quartet (transpose, then each flip) runs as a second forward
at the swapped shape (W, H).

Layout: NHWC, as the forward. A transposed or flipped view is not a
contiguous NHWC tensor; every input the wrapped forward sees is made
contiguous first, because the CAC kernels take contiguous NHWC only.
"""
from __future__ import annotations

import torch

_FLIP_DIMS = ((), (1,), (2,), (1, 2))   # id / V / H / HV


def _flip(t: torch.Tensor, dims) -> torch.Tensor:
    return torch.flip(t, dims) if dims else t


def _tr(t: torch.Tensor) -> torch.Tensor:
    """Transpose the spatial axes of an NHW[C] tensor (a view)."""
    return t.transpose(1, 2)


def make_tta_forward(fwd, mode: str = "batched", transforms: int = 4):
    """Wrap fwd(params, depth, color, mask) -> out with a geometric ensemble.

    fwd must be shape-equivariant under the transforms (any fully
    convolutional net); the wrapper is then flip-equivariant:
    tta(flip(x)) == flip(tta(x)) up to the order of float sums.

    transforms: 4 (flips) or 8 (flips and their transposes: D4).
    mode="batched": the 4 flips ride one forward at 4x batch, and for
    transforms=8 the transposed 4 a second forward at (W, H).
    mode="sequential": one forward per transform.
    """
    if transforms not in (4, 8):
        raise ValueError(f"transforms must be 4 or 8, got {transforms}")
    if mode == "batched":
        def quartet(params, d, c, m):
            def stack(t):
                # cat allocates a contiguous (4b, ...) tensor
                return torch.cat([_flip(t, dims) for dims in _FLIP_DIMS], 0)

            out = fwd(params, stack(d), stack(c),
                      None if m is None else stack(m))
            # (4b, ...) -> (4, b, ...), as the JAX package reshapes
            out4 = out.reshape((4, d.shape[0]) + tuple(out.shape[1:]))
            return sum(_flip(out4[i], dims)
                       for i, dims in enumerate(_FLIP_DIMS))

        def tta(params, depth, color, mask):
            acc = quartet(params, depth, color, mask)
            if transforms == 8:
                acc = acc + _tr(quartet(
                    params, _tr(depth), _tr(color),
                    None if mask is None else _tr(mask)))
            return (acc / float(transforms)).contiguous()

        return tta
    if mode != "sequential":
        raise ValueError(f"mode must be 'batched' or 'sequential', got "
                         f"{mode!r}")

    def tta(params, depth, color, mask):
        acc = None
        for k in range(transforms // 4):
            tr = _tr if k else (lambda t: t)
            for dims in _FLIP_DIMS:
                def tf(t, dims=dims, tr=tr):
                    return _flip(tr(t), dims).contiguous()

                def inv(t, dims=dims, tr=tr):
                    return tr(_flip(t, dims))

                o = inv(fwd(params, tf(depth), tf(color),
                            None if mask is None else tf(mask)))
                acc = o if acc is None else acc + o
        return (acc / float(transforms)).contiguous()

    return tta
