"""Attention primitives of the ablation zoo, in PyTorch, on NHWC tensors.

The counterpart of `codon_tpu.models.attention`: plain functions over FLAT
parameter dicts keyed by the reference's own torch parameter names (for
example "non1.ChannelGate.mlp.1.weight"), with the JAX package's layouts
(conv kernels HWIO, linear weights (in, out)), so that a reference state
dict converts by rank alone (`checkpoint.torch_convert.
generic_state_dict_to_flat`).

The three modules the reference release imports but does not ship are
interpreted as in the JAX package:
  * attention.CBAM.CBAM(C)  -> ChannelGate(C, r=16), then SpatialGate(k=5),
                               the gated output, no residual
  * wechat_2.CA(C)          -> the full-width channel gate's SCALE
  * wechat_2.SA()           -> the spatial gate's SCALE (k=5)

Every primitive takes the optional (N, H, W, 1) validity mask: the global
reductions run over valid pixels only and every conv output is re-masked,
so a padded mixed-size batch computes what each image alone would. The
gates compute in plain PyTorch ops, as the JAX package's run in XLA: no
hand-written kernel is on this path.
"""
from __future__ import annotations

from typing import Sequence

import torch


# ---------------------------------------------------------------------------
# flat-param helpers
# ---------------------------------------------------------------------------

def conv_p(p, name, t, ops, mask=None, groups=1):
    """Conv by flat torch name; adds `{name}.bias` when present, then
    re-masks. No site name reaches the backend, as in the JAX package."""
    out = ops.conv2d(t, p[f"{name}.weight"], mask=mask, groups=groups)
    b = p.get(f"{name}.bias")
    if b is not None:
        out = out + b.to(out.dtype)
        if mask is not None:
            out = out * mask.to(out.dtype)
    return out


def linear_p(p, name, v):
    out = v @ p[f"{name}.weight"].to(v.dtype)
    b = p.get(f"{name}.bias")
    return out if b is None else out + b.to(v.dtype)


# ---------------------------------------------------------------------------
# gate primitives (CBAM / CAC family)
# ---------------------------------------------------------------------------

def channel_gate_scale(p, prefix, x, ops, mask=None,
                       pool_types: Sequence[str] = ("avg", "max")):
    """ResCBAM's ChannelGate pooled-MLP SCALE (full width), (N, 1, 1, C).

    x: (N, H, W, C), or a tuple of tensors pooled part by part with the
    pooled vectors concatenated (the CAC-style gates: no channel concat of
    the activations is built).
    """
    parts = x if isinstance(x, tuple) else (x,)

    def pools(kind):
        pool = ops.global_avg if kind == "avg" else ops.global_max
        return torch.cat([pool(t, mask)[:, 0, 0, :] for t in parts], -1)

    att = None
    for kind in pool_types:
        v = torch.relu(linear_p(p, f"{prefix}.mlp.1", pools(kind)))
        v = linear_p(p, f"{prefix}.mlp.3", v)
        att = v if att is None else att + v
    return torch.sigmoid(att)[:, None, None, :]


def spatial_gate_scale(p, prefix, x, ops, mask=None):
    """Channel pool (max, mean) -> k x k conv (2 -> 1) -> sigmoid SCALE,
    (N, H, W, 1). x: a tensor or a tuple of parts pooled together."""
    parts = x if isinstance(x, tuple) else (x,)
    cmax = parts[0].amax(-1, keepdim=True)
    csum = parts[0].sum(-1, keepdim=True)
    n = parts[0].shape[-1]
    for t in parts[1:]:
        cmax = torch.maximum(cmax, t.amax(-1, keepdim=True))
        csum = csum + t.sum(-1, keepdim=True)
        n += t.shape[-1]
    pooled = torch.cat([cmax, csum / n], -1)
    return torch.sigmoid(conv_p(p, f"{prefix}.spatial.conv", pooled, ops,
                                mask))


def channel_gate(p, prefix, x, ops, mask=None, pool_types=("avg", "max")):
    """ResCBAM ChannelGate: x * scale."""
    return x * channel_gate_scale(p, prefix, x, ops, mask, pool_types)


def spatial_gate(p, prefix, x, ops, mask=None):
    """ResCBAM SpatialGate: x * scale."""
    return x * spatial_gate_scale(p, prefix, x, ops, mask)


def res_cbam(p, prefix, x, ops, mask=None, pool_types=("avg", "max")):
    """ResCBAM{,_c,_d}: ChannelGate -> SpatialGate -> + x."""
    out = channel_gate(p, f"{prefix}.ChannelGate", x, ops, mask, pool_types)
    out = spatial_gate(p, f"{prefix}.SpatialGate", out, ops, mask)
    return out + x


def cbam(p, prefix, x, ops, mask=None):
    """The interpreted attention.CBAM.CBAM: gated output, no residual."""
    out = channel_gate(p, f"{prefix}.ChannelGate", x, ops, mask)
    return spatial_gate(p, f"{prefix}.SpatialGate", out, ops, mask)


def ca_layer(p, prefix, x, ops, mask=None):
    """RCAN CALayer: masked avgpool -> 1x1 conv C/16 -> relu -> 1x1 ->
    sigmoid -> x * y. The 1x1 convs run on the (N, 1, 1, C) pooled vector,
    unmasked."""
    y = ops.global_avg(x, mask)
    y = torch.relu(conv_p(p, f"{prefix}.conv_du.0", y, ops))
    y = torch.sigmoid(conv_p(p, f"{prefix}.conv_du.2", y, ops))
    return x * y


# ---------------------------------------------------------------------------
# non-local primitives
# ---------------------------------------------------------------------------

def _whole_image(ops, what):
    """Raise NotImplementedError when `ops` holds one shard of the image
    (`parallel.ops.ShardedOps`): whole-image attention there would attend
    within the shard, finite and wrong. JAX documents the same primitives
    as single-shard only."""
    if getattr(ops, "sharded", False):
        raise NotImplementedError(
            f"{what} attends over the whole image: it does not run on a "
            f"spatial shard (no zoo net calls it)")


def pam(p, prefix, x, ops, mask=None):
    """Position attention (DANet): softmax(Q K^T) over pixels.

    Quadratic in pixels: its (N, HW, HW) energy alone is 136 GB in float32
    at 480 x 384, so it runs at small sizes only (no net reaches it).
    Whole images only: a sharded backend raises.
    """
    _whole_image(ops, "pam")
    n, h, w, c = x.shape
    q = conv_p(p, f"{prefix}.query_conv", x, ops, mask).reshape(n, h * w, -1)
    k = conv_p(p, f"{prefix}.key_conv", x, ops, mask).reshape(n, h * w, -1)
    v = conv_p(p, f"{prefix}.value_conv", x, ops, mask).reshape(n, h * w, c)
    energy = torch.einsum("bic,bjc->bij", q, k)
    if mask is not None:
        # an invalid KEY pixel would add exp(0) to every softmax
        # denominator, diluting the valid weights against per-image runs
        kmask = mask.reshape(n, 1, h * w) > 0
        energy = energy.masked_fill(~kmask, float("-inf"))
    att = torch.softmax(energy, dim=-1)
    out = torch.einsum("bij,bjc->bic", att, v).reshape(n, h, w, c)
    gamma = p[f"{prefix}.gamma"].to(x.dtype)
    # an invalid QUERY pixel attends to valid values: re-mask so that the
    # next conv's stencil reads zeros there, as per-image padding gives
    return gamma * ops.apply_mask(out, mask) + x


def cam(p, prefix, x, ops=None, mask=None):
    """Channel attention: C x C gram, max-subtracted softmax. Whole
    images only: a sharded backend raises."""
    _whole_image(ops, "cam")
    n, h, w, c = x.shape
    xf = x.reshape(n, h * w, c)
    energy = torch.einsum("bpi,bpj->bij", xf, xf)
    energy_new = energy.amax(-1, keepdim=True) - energy
    att = torch.softmax(energy_new, dim=-1)
    out = torch.einsum("bij,bpj->bpi", att, xf).reshape(n, h, w, c)
    gamma = p[f"{prefix}.gamma"].to(x.dtype)
    return gamma * out + x


def sepnon(p, prefix, x, ops, mask=None):
    """SEPNON: the PAM and CAM heads summed. conv6/conv7 are carried but
    not read, as in the reference; Dropout2d is off (eval)."""
    feat1 = torch.relu(conv_p(p, f"{prefix}.conv5a.0", x, ops, mask))
    sa = pam(p, f"{prefix}.sa", feat1, ops, mask)
    sa = torch.relu(conv_p(p, f"{prefix}.conv51.0", sa, ops, mask))
    feat2 = torch.relu(conv_p(p, f"{prefix}.conv5c.0", x, ops, mask))
    sc = cam(p, f"{prefix}.sc", feat2, ops, mask)
    sc = torch.relu(conv_p(p, f"{prefix}.conv52.0", sc, ops, mask))
    return conv_p(p, f"{prefix}.conv8.1", sa + sc, ops, mask)


def spatial_cgnl(p, prefix, x, ops, mask=None, groups: int = 8,
                 use_scale: bool = False):
    """Compact generalized non-local block (SpatialCGNL). Per group the
    attention is one scalar, the masked sum over pixels and the group's
    channels of p * g, that scales t; then the grouped 1x1 `z`, a
    GroupNorm over each group's valid pixels and channels, a re-mask and
    the residual."""
    n, h, w, c = x.shape
    t = conv_p(p, f"{prefix}.t", x, ops, mask)
    pp = conv_p(p, f"{prefix}.p", x, ops, mask)
    g = conv_p(p, f"{prefix}.g", x, ops, mask)
    cg = t.shape[-1] // groups

    s = ops.global_sum(pp * g, mask)[:, 0, 0, :]       # (N, planes)
    s = s.reshape(n, groups, cg).sum(-1)               # (N, groups)
    if use_scale:
        # each image's valid pixels, (N, 1)
        cnt = ops.global_sum(torch.ones_like(x[..., :1]), mask)[:, 0, 0, :]
        s = s / torch.sqrt(float(cg) * cnt)
    scale = torch.repeat_interleave(s, cg, dim=1)[:, None, None, :]
    xk = t * scale.to(t.dtype)

    xk = conv_p(p, f"{prefix}.z", xk, ops, mask, groups=groups)
    # GroupNorm statistics over valid pixels: per channel first, then
    # averaged over the group's channels (all share one pixel count, so
    # the two-level mean is exact)
    cgz = c // groups
    mean_c = ops.global_avg(xk, mask)
    gmean = mean_c.reshape(n, 1, 1, groups, cgz).mean(-1, keepdim=True)
    mean_b = gmean.expand(n, 1, 1, groups, cgz).reshape(n, 1, 1, c)
    var_c = ops.global_avg((xk - mean_b) ** 2, mask)
    gvar = var_c.reshape(n, 1, 1, groups, cgz).mean(-1, keepdim=True)
    xg = xk.reshape(n, h, w, groups, cgz)
    xg = (xg - gmean) / torch.sqrt(gvar + 1e-5)
    xk = xg.reshape(n, h, w, c)
    gam = p[f"{prefix}.gn.weight"].to(xk.dtype)
    bet = p[f"{prefix}.gn.bias"].to(xk.dtype)
    # the affine maps the padding's zeros to bet: re-mask
    return ops.apply_mask(xk * gam + bet, mask) + x


def nonlocal_bn(p, prefix, x, ops, mask=None, use_scale: bool = True):
    """NonLocalBlock2D_BN: one scalar attention over the whole tensor, then
    an eval-mode BatchNorm (running statistics), re-masked."""
    t = conv_p(p, f"{prefix}.t", x, ops, mask)
    pp = conv_p(p, f"{prefix}.p", x, ops, mask)
    g = conv_p(p, f"{prefix}.g", x, ops, mask)
    cp = t.shape[-1]
    att = ops.global_sum(pp * g, mask).sum(-1, keepdim=True)   # (N,1,1,1)
    if use_scale:
        cnt = ops.global_sum(torch.ones_like(x[..., :1]), mask)  # (N,1,1,1)
        att = att / torch.sqrt(float(cp) * cnt)
    xk = conv_p(p, f"{prefix}.z", att.to(t.dtype) * t, ops, mask)
    rm = p[f"{prefix}.bn4.running_mean"].to(xk.dtype)
    rv = p[f"{prefix}.bn4.running_var"].to(xk.dtype)
    wt = p[f"{prefix}.bn4.weight"].to(xk.dtype)
    bs = p[f"{prefix}.bn4.bias"].to(xk.dtype)
    xk = ops.apply_mask((xk - rm) / torch.sqrt(rv + 1e-5) * wt + bs, mask)
    return xk + x
