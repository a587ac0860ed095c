"""Weight-space average ("model soup") of same-architecture npz checkpoints.

    python -m codon_tpu_torch.soup OUT.npz IN1.npz IN2.npz [IN3.npz ...] \
        [--w 2,1,1]

The counterpart of `scripts/soup.py`, in numpy on the host alone: no
device is touched. Float leaves are averaged in float64 with the member
weights (uniform by default, or `--w`, normalized to sum 1) and cast back
to the first member's dtype; non-float leaves (e.g. shipped int8
act_scales trees) must agree across members and are taken from the first.
Only meaningful for members in one loss basin (a checkpoint and its own
fine-tunes).

The leaves are read as the JAX package's `load_npz` hands them to its
script: 64-bit types narrowed to their 32-bit kin, as JAX arrays are by
default, and taken in the sorted order of their paths, JAX's flattening
order, which numbers them in the messages. The members must have one tree
structure and, leaf by leaf, one shape and dtype; each refusal exits with
JAX's message.
"""
from __future__ import annotations

import argparse

import numpy as np

from codon_tpu_torch.checkpoint.native import load_npz, save_npz

# JAX's canonical types with 64-bit values off
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def _leaves(tree, prefix=()):
    """-> [(path, array)] in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaves(tree[k], prefix + (k,))]
    a = np.asarray(tree)
    return [(prefix, a.astype(_NARROW.get(a.dtype, a.dtype), copy=False))]


def _unflatten(items):
    tree: dict = {}
    for path, a in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def soup(trees, w):
    """Average `trees` (nested dicts of arrays) with weights w (summing to
    1) -> the soup tree; raises SystemExit as `scripts/soup.py` does."""
    first = _leaves(trees[0])
    rest = []
    for t in trees[1:]:
        leaves = _leaves(t)
        if [p for p, _ in leaves] != [p for p, _ in first]:
            raise SystemExit("member tree structures differ — same "
                             "architecture required")
        rest.append(leaves)
    out = []
    for i, (path, a0) in enumerate(first):
        arrs = [a0] + [ls[i][1] for ls in rest]
        for a in arrs[1:]:
            if a.shape != a0.shape or a.dtype != a0.dtype:
                raise SystemExit(
                    f"leaf {i}: shape/dtype mismatch across members "
                    f"({a0.shape}/{a0.dtype} vs {a.shape}/{a.dtype})")
        if not np.issubdtype(a0.dtype, np.floating):
            if any(not np.array_equal(a0, a) for a in arrs[1:]):
                raise SystemExit("non-float leaf differs across members")
            out.append((path, a0))
            continue
        acc = sum(wi * a.astype(np.float64) for wi, a in zip(w, arrs))
        out.append((path, acc.astype(a0.dtype)))
    return _unflatten(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("members", nargs="+")
    ap.add_argument("--w", default=None,
                    help="comma-separated member weights (default: uniform)")
    args = ap.parse_args(argv)

    trees = [load_npz(p) for p in args.members]
    if args.w:
        w = np.array([float(x) for x in args.w.split(",")], dtype=np.float64)
        if len(w) != len(trees):
            raise SystemExit(f"--w has {len(w)} entries for "
                             f"{len(trees)} members")
        if not ((w >= 0).all() and w.sum() > 0):
            raise SystemExit(f"--w weights must be >= 0 with a positive "
                             f"sum, got {w.tolist()}")
    else:
        w = np.ones(len(trees), dtype=np.float64)
    w = w / w.sum()
    save_npz(args.out, soup(trees, w))
    print(f"soup({len(trees)} members, w={w.round(3).tolist()}) "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
