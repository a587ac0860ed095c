"""cac_stats' device time at the port's four shapes, beside its bound.

    python -m codon_tpu_torch.perf_stats_probe
    python -m codon_tpu_torch.perf_stats_probe --trees OLD . . OLD

Without --trees it times this package's kernel. With --trees each DIR is a
checkout of the repo, whose own `codon_tpu_torch` is timed in a process of
its own, in the order given: two trees compared in one call on one card
go in turns (old, new, new, old).

The shapes, bfloat16, C = 64, each with the mask its path passes: the b4
eval (4, 384, 480) with 463 x 370 valid at the top left, the two TTA8
batches (16, 384, 480) and (16, 480, 384) with the same images valid, and
the training step (16, 64, 64), every pixel valid. Device time: 20 calls
captured in a CUDA graph after a warm call, the graph replayed 10 times
after a warmup, timed with CUDA events (no host time of a launch is in
it). Bound: both towers, the mask and the two maps moved once, and the
(N, 2C) sums and maxes written, over the card's 3.35 TB/s. Beside it, the
stage's two tower passes as the forward runs them: cac_stats, then
cac_apply reading the same towers again (`stage_ms`, a pair in the
graph), which shows what the one's cache policy costs the other.

With --variants NAME ... it also builds each named variant of this
package's csrc/cac.cu (`VARIANTS`: edits of the source's constants or of
the chunk map's limits), holds each against the plain version at every
shape, and times it in turns with the committed kernel (committed, the
variants, committed), each shape in one process.

Prints the card's name and power limit, each tree's (and variant's)
ptxas report of its bf16 C = 64 cac_stats kernel (registers, static
shared memory, spills), then one `RESULT {json}` line a tree (or variant)
and shape. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
GRAPH_CALLS = 20
REPLAYS = 10
# (name, (N, H, W, C), valid (h, w) of each image)
SHAPES = (("eval", (4, 384, 480, 64), (370, 463)),
          ("tta8", (16, 384, 480, 64), (370, 463)),
          ("tta8_t", (16, 480, 384, 64), (463, 370)),
          ("train", (16, 64, 64, 64), (64, 64)))
# the evict-first rule's line in csrc/cac.cu, and its evict-first load
_RULE = ("  const bool evict_first = 2LL * n * h * w * C * "
         "(long long)sizeof(T) > l2;")
_CS = "  r.raw = __ldcs(reinterpret_cast<const uint4*>(p));"
_NO_L1 = ('  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 '
          '{%0, %1, %2, %3}, [%4];" : "=r"(r.raw.x), "=r"(r.raw.y), '
          '"=r"(r.raw.z), "=r"(r.raw.w) : "l"(p));')
# name -> (edits (text, replacement) of csrc/cac.cu, stats_plan limits)
VARIANTS = {
    "unroll2": ([("kStatsUnroll = 4;", "kStatsUnroll = 2;"),
                 ("kStatsMinBlocks = 2;", "kStatsMinBlocks = 3;")], {}),
    "unroll8": ([("kStatsUnroll = 4;", "kStatsUnroll = 8;"),
                 ("kStatsMinBlocks = 2;", "kStatsMinBlocks = 1;")], {}),
    "threads512": ([("kStatsThreads = 256;", "kStatsThreads = 512;"),
                    ("kStatsMinBlocks = 2;", "kStatsMinBlocks = 1;")], {}),
    "target128": ([], {"target_chunks": 128}),
    "target512": ([], {"target_chunks": 512}),
    "minpix512": ([], {"min_pixels": 512}),
    # the towers' loads evict-first in L1 and L2 at every size, or at none
    "evict_first": ([(_RULE, "  const bool evict_first = true;")], {}),
    "keep_in_l2": ([(_RULE, "  const bool evict_first = false;")], {}),
    # other loads above L2: L2 only (ld.global.cg), or no L1 line; and the
    # latter at every size
    "ldcg": ([(_CS, "  r.raw = __ldcg(reinterpret_cast<const uint4*>(p));")],
             {}),
    "l1_no_allocate": ([(_CS, _NO_L1)], {}),
    "l1_no_allocate_all": ([(_CS, _NO_L1),
                            (_RULE, "  const bool evict_first = true;")], {}),
    # timing only, wrong maps: no per-pixel sum or max
    "no_pixel_math": ([("          px += av;\n          py += bv;\n"
                        "          pmax = fmaxf(pmax, fmaxf(av, bv));\n",
                        "")], {}),
    # timing only, wrong sums: no block adds an image's slots
    "no_finish": ([("    if (last) {\n      // every slot",
                    "    if (false) {\n      // every slot")], {}),
}
# a child process: time the codon_tpu_torch found first on sys.path
_CHILD = ("import runpy, sys; root, path = sys.argv[1:3]; "
          "sys.path.insert(0, root); sys.argv = [path, '--one']; "
          "runpy.run_path(path, run_name='__main__')")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def graph_ms(fn) -> float:
    """Device ms of one call of `fn` (see the module's docstring)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * GRAPH_CALLS)


def bound_ms(shape, element_size: int) -> float:
    n, h, w, c = shape
    nhw = n * h * w
    nbytes = (2 * nhw * c + 3 * nhw) * element_size + 2 * n * 2 * c * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def build_variants(names) -> dict:
    """Compile each variant of csrc/cac.cu alone, one nvcc each, all
    started together. -> {name: (bound library, plan limits)}."""
    import ctypes
    import tempfile
    from codon_tpu_torch.kernels import _build
    with open(os.path.join(_build.SRC_DIR, "cac.cu")) as f:
        src = f.read()
    tmp = tempfile.mkdtemp(prefix="stats_variants_", dir=_build.BUILD_DIR
                           if os.path.isdir(_build.BUILD_DIR) else None)
    jobs = {}
    for name in names:
        edits, limits = VARIANTS[name]
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in cac.cu")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(tmp, f"lib{name}.so")
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, cu]
        jobs[name] = (lib, limits, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, limits, proc) in jobs.items():
        said = "".join(proc.communicate())
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{said}")
        with open(f"{lib}.log", "w") as f:
            f.write(_build.demangle(said))
        usage = {k: v for k, v in _build.ptxas_usage(lib).items()
                 if k.startswith("cac_stats_kernel<__nv_bfloat16, (int)8,")}
        print(f"{name}: ptxas {json.dumps(usage)}", flush=True)
        bound = ctypes.CDLL(lib)
        bound.codon_cac_stats.argtypes = _build._SIGNATURES["codon_cac_stats"]
        bound.codon_cac_stats.restype = ctypes.c_int
        libs[name] = (bound, limits)
    return libs


def variant_call(lib, limits, x, y, m):
    """A variant's cac_stats on contiguous bf16 towers, as the wrapper
    calls the committed one."""
    import torch
    from codon_tpu_torch.kernels import cac as kc
    n, h, w, c = x.shape
    plan = kc.stats_plan(n, h, w, **limits)
    f32 = torch.float32
    part = torch.empty((plan.chunks, 2, 2 * c), dtype=f32, device=x.device)
    ch_sum, ch_max = (torch.empty((n, 1, 2 * c), dtype=f32, device=x.device)
                      for _ in range(2))
    cmax, cmean = (torch.empty((n, h, w), dtype=x.dtype, device=x.device)
                   for _ in range(2))
    rc = lib.codon_cac_stats(
        1, x.data_ptr(), y.data_ptr(), m.data_ptr(), part.data_ptr(),
        ch_sum.data_ptr(), ch_max.data_ptr(), cmax.data_ptr(),
        cmean.data_ptr(), n, h, w, c, c, plan.rows,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"variant cac_stats: CUDA error {rc}")
    return ch_sum, ch_max, cmax, cmean


def max_err(got, want, n_pix) -> float:
    """Largest |difference| of the means, maxes and maps."""
    scale = (1.0 / n_pix, 1.0, 1.0, 1.0)
    return max(float((g.float() - w.float()).abs().max()) * s
               for g, w, s in zip(got, want, scale))


def time_here(variants=()) -> list:
    """-> a row a shape (and variant) for the importable package's
    cac_stats and the named variants of its source."""
    import torch
    from codon_tpu_torch.kernels import _build
    from codon_tpu_torch.kernels import cac as kc
    if not torch.cuda.is_available():
        raise SystemExit("perf_stats_probe: needs a CUDA card")
    path, build_s = _build.build()
    usage = {k: v for k, v in _build.ptxas_usage(path).items()
             if "stats" in k}
    print(f"ptxas {json.dumps(usage, sort_keys=True)}", flush=True)
    libs = build_variants(variants) if variants else {}
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, shape, (vh, vw) in SHAPES:
        n, h, w, _ = shape
        mask = torch.zeros((n, h, w, 1), device="cuda")
        mask[:, :vh, :vw] = 1.0
        x, y = (torch.randn(shape, generator=g, device="cuda") * mask
                for _ in range(2))
        x, y, m = x.bfloat16(), y.bfloat16(), mask.bfloat16()
        # the rest of a stage: cac_apply reads x and y again
        inp, inp_c = (torch.randn(shape, generator=g, device="cuda")
                      .bfloat16() for _ in range(2))
        gate = torch.rand((n, 1, shape[-1]), generator=g, device="cuda")
        logits = torch.randn((n, h, w), generator=g,
                             device="cuda").bfloat16()
        b = bound_ms(shape, x.element_size())
        want = kc.cac_stats_plain(x, y, m)
        before = kc.cac_stats.launches
        err = max_err(kc.cac_stats(x, y, m), want, h * w)
        launches = kc.cac_stats.launches - before
        turns = [("committed", None)] + [(v, libs[v]) for v in variants]
        if variants:
            turns.append(("committed", None))
        for label, lib in turns:
            fn = ((lambda: kc.cac_stats(x, y, m)) if lib is None else
                  (lambda lib=lib: variant_call(*lib, x, y, m)))
            row = {"shape": name, "nhwc": list(shape)}
            if variants:
                row["variant"] = label
            ms = graph_ms(fn)

            def stage(fn=fn):
                fn()
                kc.cac_apply(x, y, inp, inp_c, gate, logits)
            row.update({"device_ms": ms, "stage_ms": graph_ms(stage),
                        "bound_ms": b,
                        "share_of_bound": b / ms,
                        "max_err_vs_plain": (err if lib is None else
                                             max_err(fn(), want, h * w))})
            if lib is None:
                row.update({"launches_a_call": launches, "build_s": build_s})
            rows.append(row)
        del x, y, m, mask, want, inp, inp_c, gate, logits
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="checkouts whose codon_tpu_torch to time, in turn")
    ap.add_argument("--variants", nargs="+", default=[],
                    choices=sorted(VARIANTS),
                    help="variants of csrc/cac.cu to time beside it")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one or not args.trees:
        if not args.one:
            print(f"card {card_line()}", flush=True)
        for r in time_here(args.variants):
            print(f"RESULT {json.dumps(r)}", flush=True)
        return 0
    print(f"card {card_line()}", flush=True)
    for tree in args.trees:
        root = os.path.abspath(tree)
        res = subprocess.run(
            [sys.executable, "-c", _CHILD, root, os.path.abspath(__file__)],
            cwd=root, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("RESULT "):
                row = {"tree": tree, **json.loads(line[len("RESULT "):])}
                print(f"RESULT {json.dumps(row)}", flush=True)
            else:
                print(f"{tree}: {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
