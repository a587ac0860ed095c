"""Tile-and-stitch inference of frames too tall for one forward, on one
device.

The counterpart of `codon_tpu.parallel.stitch`. Two large-frame strategies:

  exact        shard the frame's H axis over a mesh (`parallel.tiling`):
               halo-exchange convs and all-reduced CAC statistics keep the
               result equal to the untiled forward
  this module  overlapping tiles along H, run one after another on one
               device, centre-cropped and stitched. The conv stencils are
               exact when `halo` covers the receptive-field radius (47 rows
               for CODONNet: the stems 1 + 1, each of the 5 MC stages 2 + 2
               + 2, the fusion 1 + 3 x 4 + 1 + 1); the CAC gates pool over
               each tile rather than the frame, the only divergence
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_HALO = 48  # >= CODONNet's stencil receptive-field radius (47 rows)


def tile_stitch_infer(variant, params, depth, color, *, tile_h: int = 512,
                      halo: int = DEFAULT_HALO, fwd=None):
    """depth/color: (1, H, W, 1) arrays -> numpy (1, H, W, 1).

    Tiles of `tile_h` rows with `halo` rows of context on each side run
    the forward (on the params' device; `fwd(params, depth, color)` in
    place of `variant.forward`); each tile's centre rows are kept. Every
    tile has the same height, so the forward sees one shape. A frame no
    taller than one padded tile runs whole (exact).
    """
    if fwd is None:
        def fwd(p, d, c):
            return variant.forward(p, d, c)
    dev = params_device(params)

    def run(d, c):
        out = fwd(params, torch.as_tensor(np.ascontiguousarray(d)).to(dev),
                  torch.as_tensor(np.ascontiguousarray(c)).to(dev))
        return out.float().cpu().numpy()

    depth, color = np.asarray(depth), np.asarray(color)
    _, H, W, _ = depth.shape
    want = tile_h + 2 * halo
    if H <= want:
        # whole: padding the frame to `want` rows would feed unmasked zero
        # rows into the CAC pools, and every tile would span the frame
        return run(depth, color)
    out = np.zeros((1, H, W, 1), np.float32)
    y = 0
    while y < H:
        y1 = min(y + tile_h, H)
        top, bot = max(0, y - halo), min(H, y1 + halo)
        # a constant tile height; H > want keeps a full tile inside
        if bot - top < want:
            if top == 0:
                bot = want
            else:
                top = bot - want
        o = run(depth[:, top:bot], color[:, top:bot])
        out[:, y:y1] = o[:, y - top:y1 - top]
        y = y1
    return out


def params_device(tree) -> torch.device:
    """The device of a parameter tree's first tensor."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device
