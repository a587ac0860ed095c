"""CODONNet, the flagship cross-domain attention depth-SR network, in PyTorch.

The counterpart of `codon_tpu.models.codon_net` (`codon_forward` and what it
needs): the same parameter tree (HWIO convs, `(in, out)` linears, the
per-stage CAC parameters stacked on a leading axis under `cac/`), the same
NHWC layout at the public functions, and the same structure:

  depth stem:  input(1->64,3x3) -> conv_input(64->64,3x3)         [relu each]
  color stem:  input_c(1->64,3x3) -> conv_input_c(64->64,3x3)
  5x interleaved MC+CAC stages (shared conv weights, per-stage CAC weights):
    depth cell: cat(relu(conv1 3x3), relu(conv2 5x5)) -> relu(conv3 5x5,128)
                -> confuse 1x1 -> 64
    color cell: cat(relu(conv4 5x5), relu(conv5 3x3)) [swapped when
                color_cat_swapped] -> relu(conv6 5x5,128) -> confuse_c 1x1
    CAC: Fcat = cat(out_c, out) [color first] -> channel gate (global avg +
         max pool -> MLP 128->8->64 -> sigmoid) x spatial gate (channel max +
         mean -> 5x5 conv 2->1 -> sigmoid); both towers gated, + stem skip.
  fusion: cat(out, out_c) -> conv7 3x3 128->64; 3x (conv8 5x5 || conv9 3x3
          -> conv10 5x5,128 -> confuse_fuse 1x1 -> +fuse); head:
          relu(conv11 3x3) -> output 64->1 3x3 -> + depth channel 0.

The CAC stage runs either through the three CUDA kernels
(`cac_impl="kernel"`, `kernels/cac.py`) or as plain PyTorch ops mirroring
the JAX package's XLA stage (`cac_impl="torch"`). The default takes the
kernels for CUDA tensors and the plain ops for CPU tensors.

Two more forwards take the same parameter tree: `codon_forward_fused`
runs both towers in one 2W-channel tensor with grouped convs (variant
`codon_fused`), and `sequential_tower_forward` runs the towers one after
the other with no CAC (variant `rmcr_fuse_rmcr`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.core.ops import TorchOps
from codon_tpu_torch.core.params import (DTypePolicy, FP32, conv_kernel_init,
                                         full_fp32, linear_init)
from codon_tpu_torch.kernels.cac import cac_stage


@dataclasses.dataclass(frozen=True)
class CodonConfig:
    width: int = 64
    num_mc: int = 5            # cross-attention MC stages
    num_fuse: int = 3          # fusion MC stages
    # depth-stem input channels; 2 = scale-conditioned (channel 1 is a
    # constant scale/16 plane). The residual and head read channel 0.
    in_channels: int = 1
    use_cac: bool = True
    cac_reduction: int = 16    # channel-gate MLP bottleneck: 2W/reduction
    spatial_kernel: int = 5    # CAC spatial gate conv kernel
    dead_heads: bool = False   # X4/X8 checkpoint-compat unused params
    # color cell cats (3x3, 5x5) instead of (5x5, 3x3): the
    # CODON_X16/model/CODONet.py flavor, weight-compatible
    color_cat_swapped: bool = False
    dtypes: DTypePolicy = FP32
    # CAC stage: "kernel" (the three CUDA kernels; on CPU tensors their
    # plain versions) or "torch" (plain ops, as the JAX package's XLA
    # stage). None takes "kernel" for CUDA tensors, "torch" for CPU ones.
    cac_impl: Optional[str] = None
    # "packed": each cell's 3x3 || 5x5 pair as ONE 5x5 C->2C conv (the 3x3
    # zero-embedded); "split": two convs and a concat. Same function.
    cell_impl: str = "packed"

    @property
    def cat_width(self) -> int:
        return 2 * self.width


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_codon_params(gen: torch.Generator, cfg: CodonConfig = CodonConfig(),
                      device="cuda"):
    """The CODONNet parameter tree, drawn from `gen`.

    Conv kernels HWIO, N(0, sqrt(2/(k^2*C_out))); CAC params stacked over
    stages on a leading axis of size num_mc.
    """
    device = resolve_device(device)
    w, cw = cfg.width, cfg.cat_width
    hid = cw // cfg.cac_reduction
    pd = cfg.dtypes.param_dtype

    def conv(kh, ci, co):
        return conv_kernel_init(gen, kh, kh, ci, co, dtype=pd, device=device)

    def linear(ci, co):
        return linear_init(gen, ci, co, dtype=pd, device=device)

    params = {
        "input": conv(3, cfg.in_channels, w),
        "conv_input": conv(3, w, w),
        "conv1": conv(3, w, w),
        "conv2": conv(5, w, w),
        "conv3": conv(5, cw, cw),
        "confuse": conv(1, cw, w),
        "input_c": conv(3, 1, w),
        "conv_input_c": conv(3, w, w),
        "conv4": conv(5, w, w),
        "conv5": conv(3, w, w),
        "conv6": conv(5, cw, cw),
        "confuse_c": conv(1, cw, w),
        "conv7": conv(3, cw, w),
        "conv8": conv(5, w, w),
        "conv9": conv(3, w, w),
        "conv10": conv(5, cw, cw),
        "confuse_fuse": conv(1, cw, w),
        "conv11": conv(3, w, w),
        "output": conv(3, w, 1),
    }

    if cfg.use_cac:
        stages = {"ch_w1": [], "ch_b1": [], "ch_w2": [], "ch_b2": [],
                  "sp_w": []}
        sk = cfg.spatial_kernel
        for _ in range(cfg.num_mc):
            w1, b1 = linear(cw, hid)
            w2, b2 = linear(hid, w)
            for k, v in zip(("ch_w1", "ch_b1", "ch_w2", "ch_b2"),
                            (w1, b1, w2, b2)):
                stages[k].append(v)
            stages["sp_w"].append(conv_kernel_init(gen, sk, sk, 2, 1,
                                                   dtype=pd, device=device))
        params["cac"] = {k: torch.stack(v) for k, v in stages.items()}

    if cfg.dead_heads:
        # unused in forward; carried so X4/X8 checkpoints round-trip
        hid5 = w // cfg.cac_reduction
        w1, b1 = linear(w, hid5)
        w2, b2 = linear(hid5, w)
        params["attention_c5"] = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
        params["attention_s5"] = {
            "sp_w": conv_kernel_init(gen, cfg.spatial_kernel,
                                     cfg.spatial_kernel, 2, 1, dtype=pd,
                                     device=device)}
    return params


# --------------------------------------------------------------------------
# kernel packing (cell_impl="packed")
# --------------------------------------------------------------------------

def pack_kernel_pair(ka, kb):
    """(kh_a,kw_a,C,Oa) + (kh_b,kw_b,C,Ob) -> (kh,kw,C,Oa+Ob), the smaller
    kernel zero-embedded in the larger window: relu(conv(x, packed)) ==
    cat(relu(conv(x, ka)), relu(conv(x, kb)))."""
    kh = max(ka.shape[0], kb.shape[0])

    def emb(k):
        ph = (kh - k.shape[0]) // 2
        pw = (kh - k.shape[1]) // 2
        if ph == 0 and pw == 0:
            return k
        # F.pad pads the last dims first: (I, O untouched), then W, then H
        return torch.nn.functional.pad(k, (0, 0, 0, 0, pw, pw, ph, ph))

    return torch.cat([emb(ka), emb(kb)], dim=3)


# --------------------------------------------------------------------------
# CAC gates (the plain stage, cac_impl="torch")
# --------------------------------------------------------------------------

def cac_channel_gate(fcat, w1, b1, w2, b2, ops: TorchOps, mask=None):
    """Global avg+max pool over HW -> shared MLP -> sigmoid -> (N,1,1,W).

    fcat: the (color, depth) pair of towers; the pooled vectors are
    concatenated in that order instead of the activations.
    """
    avg = torch.cat([ops.global_avg(t, mask)[:, 0, 0] for t in fcat], -1)
    mx = torch.cat([ops.global_max(t, mask)[:, 0, 0] for t in fcat], -1)

    def mlp(v):
        h = torch.relu(v @ w1.to(v.dtype) + b1.to(v.dtype))
        return h @ w2.to(v.dtype) + b2.to(v.dtype)

    gate = torch.sigmoid(mlp(avg) + mlp(mx))
    return gate[:, None, None, :]


def cac_spatial_gate(fcat, sp_w, ops: TorchOps, mask=None):
    """Channel max+mean -> kxk conv (2->1, masked) -> sigmoid -> (N,H,W,1).

    fcat: the (color, depth) pair of equal-width towers; the channel pools
    of the concat decompose as max(max_a, max_b) and (mean_a + mean_b) / 2.
    """
    a, b = fcat
    cmax = torch.maximum(a.amax(-1, keepdim=True), b.amax(-1, keepdim=True))
    cmean = (a.mean(-1, keepdim=True) + b.mean(-1, keepdim=True)) * 0.5
    pooled = torch.cat([cmax, cmean], -1)
    return torch.sigmoid(ops.conv2d(pooled, sp_w, mask=mask))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _use_kernels(cfg: CodonConfig, t: torch.Tensor) -> bool:
    if cfg.cac_impl is None:
        return t.device.type == "cuda"
    if cfg.cac_impl not in ("kernel", "torch"):
        raise ValueError(f"cac_impl must be 'kernel', 'torch' or None, got "
                         f"{cfg.cac_impl!r}")
    return cfg.cac_impl == "kernel"


@torch.no_grad()
def codon_forward(params, depth, color, *, cfg: CodonConfig = CodonConfig(),
                  ops: Optional[TorchOps] = None, mask=None):
    """Run CODONNet. depth (N,H,W,in_channels), color (N,H,W,1), in [0, 1],
    on the device of the params. Returns float32 (N,H,W,1).

    mask (N,H,W,1), optional: validity of padded batches; batched mixed-size
    inference then equals per-image inference. Float32 convs and matmuls run
    in full float32 (TF32 off).
    """
    with full_fp32():
        return _forward(params, depth, color, cfg,
                        TorchOps() if ops is None else ops, mask)


def _forward(params, depth, color, cfg, ops, mask):
    cdt = cfg.dtypes.compute_dtype
    relu = torch.relu
    p = params

    x = depth.to(cdt)
    y = color.to(cdt)
    if mask is not None:
        mask = mask.to(cdt).contiguous()
        x = x * mask
        y = y * mask

    def conv(name_or_w, t, site=None):
        if isinstance(name_or_w, str):
            w, site = p[name_or_w], name_or_w
        else:
            w = name_or_w
        return ops.conv2d(t, w, mask=mask, name=site)

    # channel 0 is the depth map; extra (conditioning) channels feed the
    # stem but not the residual
    residual = x[..., :1]
    inputs = relu(conv("conv_input", relu(conv("input", x))))
    inputs_c = relu(conv("conv_input_c", relu(conv("input_c", y))))
    inputs = ops.roundtrip(inputs, name="stem_d")
    inputs_c = ops.roundtrip(inputs_c, name="stem_c")
    out, out_c = inputs, inputs_c

    cac = p.get("cac") if cfg.use_cac else None
    use_kernels = cac is not None and _use_kernels(cfg, x)

    packed = cfg.cell_impl == "packed"
    if packed:
        m_d = pack_kernel_pair(p["conv1"], p["conv2"])
        c_pair = [p["conv4"], p["conv5"]]
        if cfg.color_cat_swapped:
            c_pair.reverse()
        m_c = pack_kernel_pair(*c_pair)
        m_f = pack_kernel_pair(p["conv8"], p["conv9"])
    elif cfg.cell_impl != "split":
        raise ValueError(f"cell_impl must be 'packed' or 'split', got "
                         f"{cfg.cell_impl!r}")

    def mc_stage(out, out_c, cac_i):
        if packed:
            d_cat = relu(conv(m_d, out, site="packed_d"))
            c_cat = relu(conv(m_c, out_c, site="packed_c"))
        else:
            d_cat = torch.cat([relu(conv("conv1", out)),
                               relu(conv("conv2", out))], -1)
            c_parts = [relu(conv("conv4", out_c)), relu(conv("conv5", out_c))]
            if cfg.color_cat_swapped:
                c_parts.reverse()
            c_cat = torch.cat(c_parts, -1)
        out = conv("confuse", relu(conv("conv3", d_cat)))
        out_c = conv("confuse_c", relu(conv("conv6", c_cat)))
        out = ops.roundtrip(out, name="gate_d")
        out_c = ops.roundtrip(out_c, name="gate_c")

        if cac_i is None:
            return out + inputs, out_c + inputs_c
        if use_kernels:
            return cac_stage(out, out_c, inputs, inputs_c, cac_i["ch_w1"],
                             cac_i["ch_b1"], cac_i["ch_w2"], cac_i["ch_b2"],
                             cac_i["sp_w"], mask)
        # Fcat = cat(color, depth), kept as a pair: the 2W-channel concat
        # is never built
        fcat = (out_c, out)
        ch = cac_channel_gate(fcat, cac_i["ch_w1"], cac_i["ch_b1"],
                              cac_i["ch_w2"], cac_i["ch_b2"], ops, mask)
        sp = cac_spatial_gate(fcat, cac_i["sp_w"], ops, mask)
        ad = ch * sp
        return out * ad + inputs, out_c * ad + inputs_c

    def fuse_stage(out_f, fuse):
        if packed:
            f_cat = relu(conv(m_f, out_f, site="packed_f"))
        else:
            f_cat = torch.cat([relu(conv("conv8", out_f)),
                               relu(conv("conv9", out_f))], -1)
        return conv("confuse_fuse", relu(conv("conv10", f_cat))) + fuse

    pc = ops.precommit if packed else (lambda t, name=None: t)
    out = pc(out, name="packed_d")
    out_c = pc(out_c, name="packed_c")
    for i in range(cfg.num_mc):
        cac_i = {k: v[i] for k, v in cac.items()} if cac is not None else None
        out, out_c = mc_stage(out, out_c, cac_i)
        if i < cfg.num_mc - 1:
            out = pc(out, name="packed_d")
            out_c = pc(out_c, name="packed_c")

    fuse = relu(conv("conv7", torch.cat([out, out_c], -1)))
    fuse = ops.roundtrip(fuse, name="fuse_r")
    out_f = pc(fuse, name="packed_f")
    for j in range(cfg.num_fuse):
        out_f = fuse_stage(out_f, fuse)
        if j < cfg.num_fuse - 1:
            out_f = pc(out_f, name="packed_f")

    out = relu(conv("conv11", out_f))
    return (conv("output", out) + residual).float()


@torch.no_grad()
def codon_forward_fused(params, depth, color, *,
                        cfg: CodonConfig = CodonConfig(),
                        ops: Optional[TorchOps] = None, mask=None):
    """Merged-tower CODONNet: `codon_forward`'s function, op for op the JAX
    package's `codon_forward_fused`.

    The towers run in ONE 2W-channel tensor T = [out | out_c] with grouped
    convs (groups=2): [input | input_c] over the stacked (depth, color)
    planes, [conv1 | conv5] as one 3x3, [conv2 | conv4] as one 5x5,
    [conv3 | conv6] as one 5x5 over the 4W `mixed` concat, [confuse |
    confuse_c] as one 1x1. The grouped convs carry compound site names
    ("conv3+conv6"), which the int8 backends resolve through the packed
    sites' scales. There are no handoffs (roundtrip, precommit), as in JAX.
    On the card the CAC stage runs the three kernels on the halves of T and
    of the stem output in place, writing the next T in one pass; on the CPU
    and under cac_impl="torch", the plain stage of the JAX form.
    `color_cat_swapped` is not lowered here and raises.
    """
    if cfg.color_cat_swapped:
        raise NotImplementedError(
            "codon_forward_fused hardcodes the cell concat order; use "
            "codon_forward for color_cat_swapped configs")
    with full_fp32():
        return _forward_fused(params, depth, color, cfg,
                              TorchOps() if ops is None else ops, mask)


def _forward_fused(params, depth, color, cfg, ops, mask):
    cdt = cfg.dtypes.compute_dtype
    relu = torch.relu
    w = cfg.width
    p = params

    x = depth.to(cdt)
    y = color.to(cdt)
    if mask is not None:
        mask = mask.to(cdt).contiguous()
        x = x * mask
        y = y * mask

    def conv(wk, t, site, groups=1):
        return ops.conv2d(t, wk, mask=mask, groups=groups, name=site)

    def cat(*ts):
        return torch.cat(ts, -1)

    # grouped kernels (k, k, C_in/2, C_out), the output channels blocked
    # by group; the stems run grouped over the 2-channel [depth | color]
    k_in = cat(p["input"], p["input_c"])                     # (3,3,1,128)
    T = relu(conv(k_in, cat(x, y), "input+input_c", 2))
    k_ci = cat(p["conv_input"], p["conv_input_c"])
    inputs2 = relu(conv(k_ci, T, "conv_input+conv_input_c", 2))
    T = inputs2

    k_3x3 = cat(p["conv1"], p["conv5"])                      # (3,3,64,128)
    k_5x5 = cat(p["conv2"], p["conv4"])                      # (5,5,64,128)
    k_big = cat(p["conv3"], p["conv6"])                      # (5,5,128,256)
    k_fuse1 = cat(p["confuse"], p["confuse_c"])

    cac = p.get("cac") if cfg.use_cac else None
    use_kernels = cac is not None and _use_kernels(cfg, x)
    for i in range(cfg.num_mc):
        A = relu(conv(k_3x3, T, "conv1+conv5", 2))           # [d3 | c3]
        B = relu(conv(k_5x5, T, "conv2+conv4", 2))           # [d5 | c5]
        # depth cell input cat(d3, d5); color cell input cat(c5, c3)
        mixed = cat(A[..., :w], B[..., :w], B[..., w:], A[..., w:])
        R2 = relu(conv(k_big, mixed, "conv3+conv6", 2))
        T = conv(k_fuse1, R2, "confuse+confuse_c", 2)       # [out | out_c]
        if cac is None:
            T = T + inputs2
            continue
        cac_i = {k: v[i] for k, v in cac.items()}
        out, out_c = T[..., :w], T[..., w:]
        if use_kernels:
            nxt = torch.empty_like(T)
            cac_stage(out, out_c, inputs2[..., :w], inputs2[..., w:],
                      cac_i["ch_w1"], cac_i["ch_b1"], cac_i["ch_w2"],
                      cac_i["ch_b2"], cac_i["sp_w"], mask,
                      dst=(nxt[..., :w], nxt[..., w:]))
            T = nxt
            continue
        ch = cac_channel_gate((out_c, out), cac_i["ch_w1"], cac_i["ch_b1"],
                              cac_i["ch_w2"], cac_i["ch_b2"], ops, mask)
        sp = cac_spatial_gate((out_c, out), cac_i["sp_w"], ops, mask)
        T = T * (cat(ch, ch) * sp) + inputs2

    # the fusion trunk consumes cat(out, out_c) == T directly
    fuse = relu(conv(p["conv7"], T, "conv7"))
    out_f = fuse
    for _ in range(cfg.num_fuse):
        f_cat = cat(relu(conv(p["conv8"], out_f, "conv8")),
                    relu(conv(p["conv9"], out_f, "conv9")))
        out_f = conv(p["confuse_fuse"], relu(conv(p["conv10"], f_cat,
                                                  "conv10")),
                     "confuse_fuse") + fuse

    out = relu(conv(p["conv11"], out_f, "conv11"))
    return (conv(p["output"], out, "output") + x).float()


@torch.no_grad()
def sequential_tower_forward(params, depth, color, *,
                             cfg: CodonConfig = CodonConfig(),
                             ops: Optional[TorchOps] = None, mask=None):
    """The attention-free skeleton (the reference's BaseNet_RMCR_fuseRMCR):
    the depth tower's five MC stages, then the color tower's, then the
    fusion trunk; no CAC (use_cac is forced off). The residual is the whole
    depth input, as in the JAX package's `sequential_tower_forward`.
    """
    cfg = dataclasses.replace(cfg, use_cac=False)
    with full_fp32():
        return _forward_sequential(params, depth, color, cfg,
                                   TorchOps() if ops is None else ops, mask)


def _forward_sequential(params, depth, color, cfg, ops, mask):
    relu = torch.relu
    cdt = cfg.dtypes.compute_dtype
    x, y = depth.to(cdt), color.to(cdt)
    if mask is not None:
        mask = mask.to(cdt).contiguous()
        x = x * mask
        y = y * mask

    def conv(n, t, site=None):
        if isinstance(n, str):
            wk, site = params[n], n
        else:
            wk = n
        return ops.conv2d(t, wk, mask=mask, name=site)

    # each cell's pair of convs, and its packed site
    pairs = {"packed_d": ("conv1", "conv2"), "packed_c": ("conv4", "conv5"),
             "packed_f": ("conv8", "conv9")}
    if cfg.cell_impl not in ("packed", "split"):
        raise ValueError(f"cell_impl must be 'packed' or 'split', got "
                         f"{cfg.cell_impl!r}")
    packed = {site: pack_kernel_pair(params[a], params[b])
              for site, (a, b) in pairs.items()
              } if cfg.cell_impl == "packed" else None

    def cell(t, site):
        if packed is not None:
            return relu(conv(packed[site], t, site=site))
        return torch.cat([relu(conv(n, t)) for n in pairs[site]], -1)

    residual = x
    inputs = relu(conv("conv_input", relu(conv("input", x))))
    out = inputs
    for _ in range(cfg.num_mc):
        out = conv("confuse", relu(conv("conv3", cell(out, "packed_d")))) \
            + inputs

    inputs_c = relu(conv("conv_input_c", relu(conv("input_c", y))))
    out_c = inputs_c
    for _ in range(cfg.num_mc):
        out_c = conv("confuse_c", relu(conv("conv6", cell(
            out_c, "packed_c")))) + inputs_c

    fuse = relu(conv("conv7", torch.cat([out, out_c], -1)))
    out_f = fuse
    for _ in range(cfg.num_fuse):
        out_f = conv("confuse_fuse", relu(conv("conv10", cell(
            out_f, "packed_f")))) + fuse

    out = relu(conv("conv11", out_f))
    return (conv("output", out) + residual).float()
