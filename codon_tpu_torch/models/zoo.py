"""The ablation zoo: every BaseNet_* network of the reference, in PyTorch.

The counterpart of `codon_tpu.models.zoo`. Each of the 27 nets is a
(parameter spec, forward) pair built from two family forwards; parameters
are FLAT dicts keyed by the reference's torch names with the JAX package's
layouts (conv kernels HWIO, linear weights (in, out)), so that JAX's
`zoo_init` parameters carry across as they are and a reference state dict
converts by rank (`checkpoint.torch_convert.generic_state_dict_to_flat`).

The reference quirks the JAX zoo reproduces are reproduced here, statement
for statement:
  * `fuse * ChannelGate(fuse)` multiplies twice: ResCBAM's ChannelGate
    returns x * scale and the nets multiply again;
  * RCAN's cross overwrite: `out = att_c(out_c); out_c = att_d(out)` reads
    the NEW depth tensor, and stage 4 reuses stage 3's gates;
  * ECCV multiplies the towers by the CBAM outputs, not by scales;
  * the cat orders differ by family: CAC nets cat color first, the Cross
    nets depth first;
  * parameters whose value never reaches the output (dead attention
    heads, the pa/ca modules, RCAN's overwritten depth cell) are
    materialized so that state dicts round-trip. Each entry lists them in
    `unread` (top-level names): the trainer gives those leaves a zero
    gradient, as JAX's is, and raises for any other leaf that gets none.

The gates are plain PyTorch (`models.attention`), as the JAX zoo's are XLA:
the zoo reaches no hand-written kernel in float. Its convs go through the
Ops backend, so the int8 backends quantize them (with no site names: every
zoo conv takes the dynamic per-sample grid). The forwards follow the
caller's grad mode: the same function evaluates and trains.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.core.ops import TorchOps
from codon_tpu_torch.core.params import FP32, full_fp32
from codon_tpu_torch.models import attention as A


# ---------------------------------------------------------------------------
# parameter-spec machinery
# ---------------------------------------------------------------------------

def _init_flat(gen: torch.Generator, spec: Dict[str, tuple],
               dtype=torch.float32, device="cuda"):
    """spec: name -> ("conv", kh, cin, cout) | ("convb", kh, cin, cout) |
    ("linear", cin, cout) | ("zeros", shape) | ("ones", shape) |
    ("conv_zeros", kh, cin, cout, groups).

    The JAX package's distributions, drawn from `gen` on the CPU in sorted
    name order: conv N(0, sqrt(2 / (kh^2 cout))), conv bias and linears
    U(-bound, bound) with bound 1/sqrt(fan_in)."""
    device = resolve_device(device)

    def uni(shape, bound):
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (2.0 * u - 1.0) * bound

    params = {}
    for name, s in sorted(spec.items()):
        kind = s[0]
        if kind in ("conv", "convb"):
            _, kh, cin, cout = s
            std = math.sqrt(2.0 / (kh * kh * cout))
            params[f"{name}.weight"] = std * torch.randn(
                (kh, kh, cin, cout), generator=gen, dtype=torch.float32)
            if kind == "convb":
                params[f"{name}.bias"] = uni((cout,),
                                             1.0 / math.sqrt(cin * kh * kh))
        elif kind == "conv_zeros":
            _, kh, cin, cout, groups = s
            params[f"{name}.weight"] = torch.zeros((kh, kh, cin // groups,
                                                    cout))
        elif kind == "linear":
            _, cin, cout = s
            bound = 1.0 / math.sqrt(cin)
            params[f"{name}.weight"] = uni((cin, cout), bound)
            params[f"{name}.bias"] = uni((cout,), bound)
        elif kind == "zeros":
            params[name] = torch.zeros(s[1])
        elif kind == "ones":
            params[name] = torch.ones(s[1])
        else:
            raise ValueError(kind)
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def _spec_channel_gate(spec, prefix, c, reduction):
    spec[f"{prefix}.mlp.1"] = ("linear", c, c // reduction)
    spec[f"{prefix}.mlp.3"] = ("linear", c // reduction, c)


def _spec_cac_channel(spec, prefix, c=128, reduction=16):
    spec[f"{prefix}.mlp.1"] = ("linear", c, c // reduction)
    spec[f"{prefix}.mlp.3"] = ("linear", c // reduction, c // 2)


def _spec_spatial_gate(spec, prefix, k=5):
    spec[f"{prefix}.spatial.conv"] = ("conv", k, 2, 1)


def _spec_rescbam(spec, prefix, c=64, reduction=8):
    _spec_channel_gate(spec, f"{prefix}.ChannelGate", c, reduction)
    _spec_spatial_gate(spec, f"{prefix}.SpatialGate")


def _spec_cbam(spec, prefix, c=64, reduction=16):
    _spec_channel_gate(spec, f"{prefix}.ChannelGate", c, reduction)
    _spec_spatial_gate(spec, f"{prefix}.SpatialGate")


def _spec_ca(spec, prefix, c=64, reduction=16):  # the interpreted wechat_2.CA
    _spec_channel_gate(spec, prefix, c, reduction)


def _spec_calayer(spec, prefix, c=64, reduction=16):
    spec[f"{prefix}.conv_du.0"] = ("convb", 1, c, c // reduction)
    spec[f"{prefix}.conv_du.2"] = ("convb", 1, c // reduction, c)


def _spec_pam(spec, prefix, c):
    spec[f"{prefix}.query_conv"] = ("convb", 1, c, c // 8)
    spec[f"{prefix}.key_conv"] = ("convb", 1, c, c // 8)
    spec[f"{prefix}.value_conv"] = ("convb", 1, c, c)
    spec[f"{prefix}.gamma"] = ("zeros", (1,))


def _spec_cam(spec, prefix):
    spec[f"{prefix}.gamma"] = ("zeros", (1,))


def _spec_cgnl(spec, prefix, c=64, planes=32, groups=8):
    for n in ("t", "p", "g"):
        spec[f"{prefix}.{n}"] = ("conv", 1, c, planes)
    spec[f"{prefix}.z"] = ("conv_zeros", 1, planes, c, groups)
    spec[f"{prefix}.gn.weight"] = ("ones", (c,))
    spec[f"{prefix}.gn.bias"] = ("zeros", (c,))


def _spec_unrolled_backbone():
    spec = {"input": ("conv", 3, 1, 64), "conv_input": ("conv", 3, 64, 64),
            "input_c": ("conv", 3, 1, 64), "conv_inputc": ("conv", 3, 64, 64),
            "output": ("conv", 3, 64, 1),
            "conv11": ("conv", 3, 128, 64)}
    for i in range(1, 11):
        spec[f"conv{i}_1"] = ("conv", 3, 64, 64)
        spec[f"conv{i}_2"] = ("conv", 3, 64, 64)
    for i in range(12, 19):
        spec[f"conv{i}"] = ("conv", 3, 64, 64)
    return spec


def _spec_mc_backbone(fusion: str = "mc"):
    spec = {"input": ("conv", 3, 1, 64), "conv_input": ("conv", 3, 64, 64),
            "conv1": ("conv", 3, 64, 64), "conv2": ("conv", 5, 64, 64),
            "conv3": ("conv", 5, 128, 128), "confuse": ("conv", 1, 128, 64),
            "input_c": ("conv", 3, 1, 64),
            "conv_input_c": ("conv", 3, 64, 64),
            "conv4": ("conv", 5, 64, 64), "conv5": ("conv", 3, 64, 64),
            "conv6": ("conv", 5, 128, 128), "confuse_c": ("conv", 1, 128, 64),
            "conv7": ("conv", 3, 128, 64), "output": ("conv", 3, 64, 1)}
    if fusion == "mc":
        spec.update({"conv8": ("conv", 5, 64, 64), "conv9": ("conv", 3, 64, 64),
                     "conv10": ("conv", 5, 128, 128),
                     "confuse_fuse": ("conv", 1, 128, 64),
                     "conv11": ("conv", 3, 64, 64)})
    else:  # the plain 2-conv fusion of BaseNet_RMCR
        spec.update({"conv8": ("conv", 3, 64, 64), "conv9": ("conv", 3, 64, 64),
                     "conv10": ("conv", 3, 64, 64)})
    return spec


def _spec_cac_stack(spec, with_c5=True):
    for i in range(5):
        _spec_cac_channel(spec, f"attention_c{i}")
        _spec_spatial_gate(spec, f"attention_s{i}")
    if with_c5:
        _spec_channel_gate(spec, "attention_c5", 64, 16)
        _spec_spatial_gate(spec, "attention_s5")


# ---------------------------------------------------------------------------
# family forwards
# ---------------------------------------------------------------------------

def _prep(depth, color, mask, dtypes, ops):
    ops = TorchOps() if ops is None else ops
    cdt = dtypes.compute_dtype
    x, y = depth.to(cdt), color.to(cdt)
    if mask is not None:
        mask = mask.to(cdt).contiguous()
        x, y = x * mask, y * mask
    return x, y, mask, ops


def _fuse_chain(p, fuse, ops, mask, hook17=None):
    """conv12..conv18; an optional attention after conv17's output."""
    relu = torch.relu

    def c(n, t):
        return A.conv_p(p, n, t, ops, mask)

    f1 = relu(c("conv13", relu(c("conv12", fuse))))
    f2 = relu(c("conv15", relu(c("conv14", f1))))
    f3 = relu(c("conv17", relu(c("conv16", f2))))
    if hook17 is not None:
        f3 = hook17(f3)
    return relu(c("conv18", f3))


def _fuse_gate_c5s5(p, fuse, ops, mask):
    """fuse * (ChannelGate output) -> * spatial scale -> + the input."""
    res = fuse
    fuse = fuse * A.channel_gate(p, "attention_c5", fuse, ops, mask,
                                 ("avg", "max"))
    fuse = fuse * A.spatial_gate_scale(p, "attention_s5", fuse, ops, mask)
    return fuse + res


# wechat_guide.ChannelGate == CAC_channel (the 128-channel cat's pools ->
# a 64-wide scale) is exactly attention.channel_gate_scale on the pair
_cac_half_gate = A.channel_gate_scale


def unrolled_forward(p, depth, color, *, dtypes=FP32, ops=None, mask=None,
                     tower_att=None, cat_order="dc", stage_gate=None,
                     fuse_att=None, cat_att=False):
    """The unrolled 10-conv dual towers (the BaseNet family).

    tower_att: None | (fn_d, fn_c, fn_fuse, fuse_pos), attention at the
               tower ends and in the fusion chain; fuse_pos "conv11" or
               "conv17".
    cat_order: "dc" depth first | "cd" color first, the fusion concat.
    stage_gate: None | "seq" | "seq_nores" | "par" | "par_res", the Cross
                family's cross gate after every second conv.
    fuse_att: None | "c5s5", the gate after conv11.
    cat_att: non_cat style, the attention output concatenated and reduced
             by a 1x1 conv.
    """
    x, y, mask, ops = _prep(depth, color, mask, dtypes, ops)
    relu = torch.relu

    def c(n, t):
        return A.conv_p(p, n, t, ops, mask)

    residual = x
    out_d = relu(c("conv_input", relu(c("input", x))))
    out_c = relu(c("conv_inputc", relu(c("input_c", y))))

    if stage_gate is None:
        for i in range(1, 11):
            out_d = relu(c(f"conv{i}_1", out_d))
        for i in range(1, 11):
            out_c = relu(c(f"conv{i}_2", out_c))
    else:
        for s in range(5):
            i1, i2 = 2 * s + 1, 2 * s + 2
            out_d = relu(c(f"conv{i1}_1", out_d))
            out_c = relu(c(f"conv{i1}_2", out_c))
            out_d = relu(c(f"conv{i2}_1", out_d))
            out_c = relu(c(f"conv{i2}_2", out_c))
            res_d, res_c = out_d, out_c
            fcat = (out_d, out_c)                    # depth first
            if stage_gate in ("seq", "seq_nores"):
                ch = _cac_half_gate(p, f"attention_c{s}", fcat, ops, mask)
                out_d, out_c = out_d * ch, out_c * ch
                sp = A.spatial_gate_scale(p, f"attention_s{s}",
                                          (out_d, out_c), ops, mask)
                out_d, out_c = out_d * sp, out_c * sp
            else:  # "par" / "par_res": the parallel mask of advise1
                ch = _cac_half_gate(p, f"attention_c{s}", fcat, ops, mask)
                sp = A.spatial_gate_scale(p, f"attention_s{s}", fcat, ops,
                                          mask)
                ad = ch * sp
                out_d, out_c = out_d * ad, out_c * ad
            if stage_gate in ("seq", "par_res"):
                out_d, out_c = out_d + res_d, out_c + res_c

    if tower_att is not None:
        fn_d, fn_c, _, _ = tower_att
        if cat_att:
            ad = fn_d(out_d, ops, mask)
            out_d = c("concat_d", torch.cat([out_d, ad], -1))
            ac = fn_c(out_c, ops, mask)
            out_c = c("concat_c", torch.cat([out_c, ac], -1))
        else:
            out_d = fn_d(out_d, ops, mask)
            out_c = fn_c(out_c, ops, mask)

    pair = (out_d, out_c) if cat_order == "dc" else (out_c, out_d)
    fuse = relu(c("conv11", torch.cat(pair, -1)))

    hook17 = None
    if fuse_att == "c5s5":
        fuse = _fuse_gate_c5s5(p, fuse, ops, mask)
    if tower_att is not None:
        _, _, fn_f, fuse_pos = tower_att
        if fn_f is not None:
            if cat_att:
                af = fn_f(fuse, ops, mask)
                fuse = c("concat_fuse", torch.cat([fuse, af], -1))
            elif fuse_pos == "conv11":
                fuse = fn_f(fuse, ops, mask)
            else:
                def hook17(t):
                    return fn_f(t, ops, mask)

    out = _fuse_chain(p, fuse, ops, mask, hook17)
    return (c("output", out) + residual).float()


def mc_forward(p, depth, color, *, dtypes=FP32, ops=None, mask=None,
               towers="sequential", stage_gate=None, fusion="mc",
               tower_att=None, fusion_att=None, fuse_gate=False):
    """The MC-cell dual towers (RMCR, fuseRMCR and the cross nets).

    towers: "sequential" | "interleaved".
    stage_gate (interleaved only): None | "cac_par" | "cac_seq" |
        "cac_seq_fused" | "cac_par2" | "cac_s" | "cac_c" | "cbam_tower" |
        "rcan_cross" | "ca_sa_depth" | "ca_sa_depth_c".
    fusion: "mc" | "plain".
    tower_att / fusion_att: optional attention fns (RMCR_NLAR's CGNL heads).
    fuse_gate: the post-conv7 gate, "c5s5" (cross) or "ca_sa" (cross2/3).
    """
    x, y, mask, ops = _prep(depth, color, mask, dtypes, ops)
    relu = torch.relu

    def c(n, t):
        return A.conv_p(p, n, t, ops, mask)

    residual = x
    inputs_d = relu(c("conv_input", relu(c("input", x))))
    inputs_c = relu(c("conv_input_c", relu(c("input_c", y))))

    def d_cell(t):
        cat = torch.cat([relu(c("conv1", t)), relu(c("conv2", t))], -1)
        return c("confuse", relu(c("conv3", cat)))

    def c_cell(t):
        cat = torch.cat([relu(c("conv4", t)), relu(c("conv5", t))], -1)
        return c("confuse_c", relu(c("conv6", cat)))

    def cs(prefix, t):
        return A.spatial_gate_scale(p, prefix, t, ops, mask)

    if towers == "sequential":
        out_d = inputs_d
        for _ in range(5):
            out_d = d_cell(out_d) + inputs_d
        out_c = inputs_c
        for _ in range(5):
            out_c = c_cell(out_c) + inputs_c
    else:
        out_d, out_c = inputs_d, inputs_c
        for i in range(5):
            out_d, out_c = d_cell(out_d), c_cell(out_c)
            fcat = (out_c, out_d)                    # color first
            if stage_gate == "cac_par":              # == CODONNet
                ad = (_cac_half_gate(p, f"attention_c{i}", fcat, ops, mask)
                      * cs(f"attention_s{i}", fcat))
                out_d, out_c = out_d * ad, out_c * ad
            elif stage_gate == "cac_par2":           # advise1_parall
                ch = _cac_half_gate(p, f"attention_c{i}", fcat, ops, mask)
                sp = cs(f"attention_s{i}", fcat)
                ch1 = _cac_half_gate(p, f"attention_c{i}1", fcat, ops, mask)
                sp1 = cs(f"attention_s{i}1", fcat)
                out_d = out_d * (ch * sp)
                out_c = out_c * (ch1 * sp1)
            elif stage_gate in ("cac_seq", "cac_seq_fused"):
                ch = _cac_half_gate(p, f"attention_c{i}", fcat, ops, mask)
                out_c, out_d = out_c * ch, out_d * ch
                sp = cs(f"attention_s{i}", (out_c, out_d))
                out_c, out_d = out_c * sp, out_d * sp
                if stage_gate == "cac_seq_fused":    # advise2
                    ad = ch * sp
                    out_c, out_d = out_c * ad, out_d * ad
            elif stage_gate == "cac_s":
                sp = cs(f"attention_s{i}", fcat)
                out_d, out_c = out_d * sp, out_c * sp
            elif stage_gate == "cac_c":
                ch = _cac_half_gate(p, f"attention_c{i}", fcat, ops, mask)
                out_d, out_c = out_d * ch, out_c * ch
            elif stage_gate == "cbam_tower":         # ECCV
                att_c = A.cbam(p, f"attention_c{i}", out_c, ops, mask)
                att_d = A.cbam(p, f"attention_d{i}", out_d, ops, mask)
                out_d = out_d * att_d
                out_c = out_c * att_c
            elif stage_gate == "rcan_cross":         # RCAN
                j = min(i, 3)                        # stage 4 reuses stage 3
                new_d = A.ca_layer(p, f"attention_c{j}", out_c, ops, mask)
                new_c = A.ca_layer(p, f"attention_d{j}", new_d, ops, mask)
                out_d, out_c = new_d, new_c
            elif stage_gate in ("ca_sa_depth", "ca_sa_depth_c"):
                # cross2 / cross3: the gates come from the depth tower
                ch = A.channel_gate_scale(p, f"attention_c{i}", out_d, ops,
                                          mask)
                if stage_gate == "ca_sa_depth_c":
                    out_c = out_c * A.channel_gate_scale(
                        p, f"attention_c{i}_c", out_c, ops, mask)
                else:
                    out_c = out_c * ch
                out_d = out_d * ch
                sp = cs(f"attention_s{i}", out_d)
                out_c, out_d = out_c * sp, out_d * sp
            out_c = out_c + inputs_c
            out_d = out_d + inputs_d

    if tower_att is not None:
        out_d = tower_att[0](out_d, ops, mask)
        out_c = tower_att[1](out_c, ops, mask)

    fuse = relu(c("conv7", torch.cat([out_d, out_c], -1)))

    if fuse_gate == "c5s5":
        fuse = _fuse_gate_c5s5(p, fuse, ops, mask)
    elif fuse_gate == "ca_sa":
        res = fuse
        fuse = fuse * A.channel_gate_scale(p, "attention_c5", fuse, ops,
                                           mask)
        fuse = fuse * cs("attention_s5", fuse)
        fuse = fuse + res

    out_f = fuse
    if fusion == "mc":
        for _ in range(3):
            cat = torch.cat([relu(c("conv8", out_f)),
                             relu(c("conv9", out_f))], -1)
            out_f = c("confuse_fuse", relu(c("conv10", cat))) + fuse
        if fusion_att is not None:
            out_f = fusion_att(out_f, ops, mask)
        out = relu(c("conv11", out_f))
    else:
        for _ in range(3):
            out_f = relu(c("conv9", relu(c("conv8", out_f)))) + fuse
        if fusion_att is not None:
            out_f = fusion_att(out_f, ops, mask)
        out = relu(c("conv10", out_f))

    return (c("output", out) + residual).float()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

ZOO: Dict[str, dict] = {}


def _entry(name, spec_fn, forward_fn, doc, unread=()):
    ZOO[name] = {"spec": spec_fn, "forward": forward_fn, "doc": doc,
                 "unread": tuple(unread)}


def zoo_init(name, gen: torch.Generator, dtype=torch.float32,
             device="cuda"):
    return _init_flat(gen, ZOO[name]["spec"](), dtype, device)


def zoo_forward(name, params, depth, color, *, dtypes=FP32, ops=None,
                mask=None):
    """Run zoo net `name`: depth and color (N, H, W, 1) in [0, 1], mask
    (N, H, W, 1) or None -> float32 (N, H, W, 1). Float32 convs and
    matmuls in full float32 (TF32 off); autograd as the caller has it."""
    with full_fp32():
        return ZOO[name]["forward"](params, depth, color, dtypes=dtypes,
                                    ops=ops, mask=mask)


def list_zoo():
    return sorted(ZOO)


def _heads(*names):
    return tuple(f"attention_{n}" for n in names)


_C5S5 = _heads("c5", "s5")

# ---- unrolled family ------------------------------------------------------

_entry("basenet", _spec_unrolled_backbone,
       lambda p, d, c, **kw: unrolled_forward(p, d, c, cat_order="dc", **kw),
       "plain unrolled towers, no attention (base_net_withoutBN.py:1010)")


def _spec_non():
    spec = _spec_unrolled_backbone()
    for n in ("non1", "non2", "non3"):
        _spec_rescbam(spec, n)
    return spec


def _mk_fwd_non(fuse_pos, pools=(("avg", "max"),) * 3):
    def fwd(p, d, c, dtypes=FP32, ops=None, mask=None):
        def head(name, pt):
            return lambda t, o, m: A.res_cbam(p, name, t, o, m, pt)
        att = tuple(head(f"non{i + 1}", pools[i]) for i in range(3))
        return unrolled_forward(p, d, c, dtypes=dtypes, ops=ops, mask=mask,
                                tower_att=att + (fuse_pos,), cat_order="cd")
    return fwd


def _spec_non_pa_ca():
    spec = _spec_non()
    _spec_pam(spec, "pa", 64)       # modules built but never called
    _spec_cam(spec, "ca")
    return spec


_entry("basenet_non_corr", _spec_non, _mk_fwd_non("conv11"),
       "unrolled towers + ResCBAM heads at tower ends and post-conv11 "
       "(base_net_withoutBN.py:174)")
_entry("basenet_non", _spec_non, _mk_fwd_non("conv11"),
       "duplicate of basenet_non_corr in the reference (:266)")
_entry("basenet_non2", _spec_non_pa_ca, _mk_fwd_non("conv17"),
       "ResCBAM heads, third one after conv17; dead pa/ca modules (:358)",
       unread=("pa", "ca"))
_entry("basenet_non3", _spec_non_pa_ca,
       _mk_fwd_non("conv11", (("max",), ("avg",), ("avg", "max"))),
       "asymmetric ResCBAM_d/_c tower heads (:451)", unread=("pa", "ca"))


def _spec_non_cat():
    spec = _spec_non()
    spec["concat_d"] = ("conv", 1, 128, 64)
    spec["concat_c"] = ("conv", 1, 128, 64)
    spec["concat_fuse"] = ("conv", 1, 128, 64)
    return spec


def _fwd_non_cat(p, d, c, dtypes=FP32, ops=None, mask=None):
    att = (lambda t, o, m: A.res_cbam(p, "non1", t, o, m),
           lambda t, o, m: A.res_cbam(p, "non2", t, o, m),
           lambda t, o, m: A.res_cbam(p, "non3", t, o, m),
           "conv11")
    return unrolled_forward(p, d, c, dtypes=dtypes, ops=ops, mask=mask,
                            tower_att=att, cat_order="cd", cat_att=True)


_entry("basenet_non_cat", _spec_non_cat, _fwd_non_cat,
       "attention outputs concatenated + 1x1 reduced instead of added (:544)")


def _spec_nlar():
    spec = _spec_unrolled_backbone()
    for n in ("non1", "non2", "non3"):
        _spec_cgnl(spec, n)
    return spec


def _fwd_nlar(p, d, c, dtypes=FP32, ops=None, mask=None):
    att = (lambda t, o, m: A.spatial_cgnl(p, "non1", t, o, m),
           lambda t, o, m: A.spatial_cgnl(p, "non2", t, o, m),
           lambda t, o, m: A.spatial_cgnl(p, "non3", t, o, m),
           "conv17")
    return unrolled_forward(p, d, c, dtypes=dtypes, ops=ops, mask=mask,
                            tower_att=att, cat_order="dc")


_entry("basenet_nlar", _spec_nlar, _fwd_nlar,
       "unrolled towers + SpatialCGNL(64,32,g8) heads (:1790)")


def _spec_cross_family():
    spec = _spec_unrolled_backbone()
    _spec_cac_stack(spec, with_c5=True)
    return spec


def _unrolled(**kw_net):
    return lambda p, d, c, **kw: unrolled_forward(p, d, c, **kw_net, **kw)


_entry("basenet_only_fuse_attention", _spec_cross_family,
       _unrolled(fuse_att="c5s5"),
       "attention only after fusion; c0..s4 dead (:1095)",
       unread=_heads(*(f"{g}{i}" for g in "cs" for i in range(5))))
_entry("basenet_cross", _spec_cross_family,
       _unrolled(stage_gate="seq", fuse_att="c5s5"),
       "sequential cross gates per stage + post-fusion gate (:1200)")
_entry("basenet_only_cross_attention", _spec_cross_family,
       _unrolled(stage_gate="seq"),
       "sequential cross gates, no fusion gate; c5/s5 dead (:1358)",
       unread=_C5S5)
_entry("basenet_only_cross_attention_advise1_nores", _spec_cross_family,
       _unrolled(stage_gate="par"),
       "parallel ch*sp mask, no per-stage residual (:1510)", unread=_C5S5)
_entry("basenet_only_cross_attention_advise1", _spec_cross_family,
       _unrolled(stage_gate="par_res"),
       "parallel ch*sp mask + per-stage residual (:1649)", unread=_C5S5)


# ---- MC family ------------------------------------------------------------

def _mc(**kw_net):
    return lambda p, d, c, **kw: mc_forward(p, d, c, **kw_net, **kw)


_entry("rmcr", lambda: _spec_mc_backbone("plain"),
       _mc(towers="sequential", fusion="plain"),
       "sequential MC towers + plain 2-conv fusion (:759)")


def _spec_rmcr_nlar():
    spec = _spec_mc_backbone("plain")
    for n in ("non1", "non2", "non3"):
        _spec_cgnl(spec, n)
    return spec


def _fwd_rmcr_nlar(p, d, c, dtypes=FP32, ops=None, mask=None):
    return mc_forward(
        p, d, c, dtypes=dtypes, ops=ops, mask=mask, towers="sequential",
        fusion="plain",
        tower_att=(lambda t, o, m: A.spatial_cgnl(p, "non1", t, o, m),
                   lambda t, o, m: A.spatial_cgnl(p, "non2", t, o, m)),
        fusion_att=lambda t, o, m: A.spatial_cgnl(p, "non3", t, o, m))


_entry("rmcr_nlar", _spec_rmcr_nlar, _fwd_rmcr_nlar,
       "RMCR + three SpatialCGNL heads (:828)")

_entry("rmcr_fuse_rmcr", _spec_mc_backbone, _mc(towers="sequential"),
       "attention-free CODON skeleton (:1882; inlined at CODON_x16.py:16)")
_entry("rmcr_fuse_rmcr_2", _spec_mc_backbone, _mc(towers="sequential"),
       "byte-duplicate of rmcr_fuse_rmcr in the reference (:1961)")


def _spec_mc_cac():
    spec = _spec_mc_backbone("mc")
    _spec_cac_stack(spec, with_c5=True)
    return spec


_entry("rmcr_fuse_rmcr_cross_advise2", _spec_mc_cac,
       _mc(towers="interleaved", stage_gate="cac_seq_fused"),
       "sequential gates + extra fused-mask multiply; c5/s5 dead (:2040)",
       unread=_C5S5)
_entry("rmcr_fuse_rmcr_cross", _spec_mc_cac,
       _mc(towers="interleaved", stage_gate="cac_seq", fuse_gate="c5s5"),
       "sequential cross gates + post-fusion c5/s5 gate (:2186)")
_entry("rmcr_fuse_rmcr_cross_only_corss_advise1", _spec_mc_cac,
       _mc(towers="interleaved", stage_gate="cac_par"),
       "== the published CODONNet (:2319; see models.codon_net for the "
       "optimized stacked-pytree implementation)", unread=_C5S5)
_entry("rmcr_fuse_rmcr_cross_only_corss", _spec_mc_cac,
       _mc(towers="interleaved", stage_gate="cac_seq"),
       "sequential cross gates, no post-fusion gate; c5/s5 dead (:3004)",
       unread=_C5S5)
_entry("rmcr_fuse_rmcr_cross_only_corss_advise1_onlys", _spec_mc_cac,
       _mc(towers="interleaved", stage_gate="cac_s"),
       "spatial-only CAC mask; channel heads dead (:2580)",
       unread=_heads(*(f"c{i}" for i in range(6)), "s5"))
_entry("rmcr_fuse_rmcr_cross_only_corss_advise1_onlyc", _spec_mc_cac,
       _mc(towers="interleaved", stage_gate="cac_c"),
       "channel-only CAC mask; spatial heads dead (:2691)",
       unread=_heads(*(f"s{i}" for i in range(6)), "c5"))


def _spec_parall():
    spec = _spec_mc_backbone("mc")
    for i in range(5):
        _spec_cac_channel(spec, f"attention_c{i}")
        _spec_spatial_gate(spec, f"attention_s{i}")
        _spec_cac_channel(spec, f"attention_c{i}1")
        _spec_spatial_gate(spec, f"attention_s{i}1")
    return spec


_entry("rmcr_fuse_rmcr_cross_only_corss_advise1_parall", _spec_parall,
       _mc(towers="interleaved", stage_gate="cac_par2"),
       "two independent CAC masks, one per tower (:2435)")


def _spec_eccv():
    spec = _spec_mc_backbone("mc")
    for i in range(5):
        _spec_cbam(spec, f"attention_c{i}")
        _spec_cbam(spec, f"attention_d{i}")
    return spec


_entry("rmcr_fuse_rmcr_eccv", _spec_eccv,
       _mc(towers="interleaved", stage_gate="cbam_tower"),
       "per-tower CBAM outputs multiplied in (:2802; CBAM interpreted — "
       "attention.CBAM missing from the release)")


def _spec_rcan():
    spec = _spec_mc_backbone("mc")
    for i in range(5):
        _spec_calayer(spec, f"attention_c{i}")
        _spec_calayer(spec, f"attention_d{i}")
    return spec


_entry("rmcr_fuse_rmcr_rcan", _spec_rcan,
       _mc(towers="interleaved", stage_gate="rcan_cross"),
       "cross-wired CALayers incl. the reference's stage-4 gate reuse and "
       "tower-overwrite quirk (:2908)",
       # stage 4 reuses stage 3's gates, and every stage overwrites the
       # depth tower with the gated color tower: the depth cell's output
       # never reaches the head
       unread=_heads("c4", "d4") + ("conv1", "conv2", "conv3", "confuse"))


def _spec_cross2():
    spec = _spec_mc_backbone("mc")
    for i in range(5):
        _spec_ca(spec, f"attention_c{i}")
        _spec_spatial_gate(spec, f"attention_s{i}")
    _spec_ca(spec, "attention_c5")
    _spec_spatial_gate(spec, "attention_s5")
    return spec


def _spec_cross3():
    spec = _spec_cross2()
    for i in range(5):
        _spec_ca(spec, f"attention_c{i}_c")
    return spec


_entry("rmcr_fuse_rmcr_cross2", _spec_cross2,
       _mc(towers="interleaved", stage_gate="ca_sa_depth", fuse_gate="ca_sa"),
       "gates computed from the depth tower only (:3137; wechat_2 CA/SA "
       "interpreted — missing from the release)")
_entry("rmcr_fuse_rmcr_cross3", _spec_cross3,
       _mc(towers="interleaved", stage_gate="ca_sa_depth_c",
           fuse_gate="ca_sa"),
       "cross2 + per-color channel gates (:3264)")
