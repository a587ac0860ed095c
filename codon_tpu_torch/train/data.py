"""Training-pair synthesis and patch sampling, in numpy and threads.

The counterpart of `codon_tpu.train.data`, draw for draw: the same inputs
and seed give the same batches. The LR depth input is the given degraded
depth (a scale dir's `input_depth/`) or, without it, the ground truth
bicubic-downsampled by the scale factor and upsampled back
(`synthesize_lr`), with the grayscale color image as guidance. The bicubic
resize is `data.resize.resize_cubic`, the port's stand-in for OpenCV's.

Batch i is a pure function of (seed, i): `sample_at(step)` seeds a
`RandomState` from `SeedSequence((seed, step))`, so a resumed run draws the
uninterrupted run's batches bitwise and the prefetch thread cannot skew
the stream.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List

import numpy as np

from codon_tpu_torch.data.resize import resize_area, resize_cubic


def synthesize_lr(label: np.ndarray, scale: int) -> np.ndarray:
    """GT depth (H, W) uint8 -> bicubic down-up degraded depth, uint8."""
    h, w = label.shape
    lr = resize_cubic(label, (max(1, w // scale), max(1, h // scale)))
    return resize_cubic(lr, (w, h))


@dataclasses.dataclass
class PatchSampler:
    """Random (depth, color, label) patch batches from image pairs.

    Fields as `codon_tpu.train.data.PatchSampler`:
      degraded       the shipped LR-upsampled depth inputs, or None to
                     synthesize them from the labels;
      augment        "full" (flips, rot90, photometric jitter of the
                     guidance, a joint range-preserving affine of depth
                     and label), "flips", or "none" / False;
      edge_bias      probability that a patch is centred, with jitter, on
                     a depth-edge pixel (|grad label| >= its 90th
                     percentile) instead of placed uniformly;
      scene_weights  per-image sampling weights (None: uniform);
      collage        probability that a patch gets a rectangle of another
                     scene's label and guidance pasted in, the degraded
                     input repaired in a band around the seam;
      cond           per-pair conditioning scalar: the depth batch gains
                     a second constant channel (scale-conditioned
                     training, `cli train --scale-cond`);
      pyramid        scales below 1 of extra levels (augment "full"
                     only): the labels and colors shrunk with OpenCV's
                     INTER_AREA (`data.resize.resize_area`), the degraded
                     maps synthesized from the shrunk labels; a patch
                     draws its level uniformly.
    """

    labels: List[np.ndarray]          # uint8 GT depth images
    colors: List[np.ndarray]          # uint8 grayscale guidance
    scale: int = 4
    patch: int = 64
    batch: int = 16
    seed: int = 0
    augment: str = "full"
    degraded: List[np.ndarray] = None
    pyramid: tuple = ()
    edge_bias: float = 0.0
    scene_weights: List[float] = None
    collage: float = 0.0
    cond: List[float] = None

    def __post_init__(self):
        if len(self.labels) != len(self.colors):
            raise ValueError(f"{len(self.labels)} labels for "
                             f"{len(self.colors)} guidance images")
        small = [i for i, l in enumerate(self.labels)
                 if min(l.shape) < self.patch]
        if small:
            shapes = [self.labels[i].shape for i in small[:3]]
            raise ValueError(
                f"{len(small)} source image(s) smaller than patch="
                f"{self.patch} (e.g. {shapes}); shrink --patch or drop "
                f"them")
        self._step = 0   # cursor for the convenience sample() wrapper
        if self.cond is not None and len(self.cond) != len(self.labels):
            raise ValueError(f"cond has {len(self.cond)} entries for "
                             f"{len(self.labels)} images")
        if self.scene_weights is not None:
            if len(self.scene_weights) != len(self.labels):
                raise ValueError(
                    f"scene_weights has {len(self.scene_weights)} entries "
                    f"for {len(self.labels)} images")
            w = np.asarray(self.scene_weights, np.float64)
            if (w < 0).any() or w.sum() <= 0:
                raise ValueError("scene_weights must be >=0 with a "
                                 "positive sum")
            self._scene_p = w / w.sum()
        else:
            self._scene_p = None
        if self.degraded is not None:
            if len(self.degraded) != len(self.labels):
                raise ValueError(f"{len(self.degraded)} degraded inputs "
                                 f"for {len(self.labels)} labels")
            base_degraded = self.degraded
        else:
            base_degraded = [synthesize_lr(l, self.scale)
                             for l in self.labels]
        # levels[k] = (labels, colors, degraded) at pyramid scale k
        self._levels = [(self.labels, self.colors, base_degraded)]
        for s in (self.pyramid if self.augment == "full" else ()):
            if s < 1.0:
                self._levels.append(self._level(s))
        self._edge_yx = None
        if self.edge_bias:
            if not 0.0 < self.edge_bias <= 1.0:
                raise ValueError(f"edge_bias must be in (0, 1], got "
                                 f"{self.edge_bias}")
            self._edge_yx = []
            for labs, _, _ in self._levels:
                per = []
                for lab in labs:
                    gy, gx = np.gradient(lab.astype(np.float32))
                    gm = np.abs(gy) + np.abs(gx)
                    # a constant-depth image has percentile 0 and would
                    # mark every pixel an edge
                    thr = max(float(np.percentile(gm, 90.0)), 1e-3)
                    per.append(np.nonzero(gm >= thr))
                self._edge_yx.append(per)

    def _level(self, s: float) -> tuple:
        """The pyramid level at scale s: labels and colors shrunk with
        OpenCV's INTER_AREA (`resize_area`), each side at least `patch`,
        and the degraded maps synthesized anew from the shrunk labels."""
        labs, cols, degs = [], [], []
        for lab, col in zip(self.labels, self.colors):
            h, w = lab.shape
            size = (max(self.patch, int(w * s)), max(self.patch, int(h * s)))
            labs.append(resize_area(lab, size))
            cols.append(resize_area(col, size))
            degs.append(synthesize_lr(labs[-1], self.scale))
        return labs, cols, degs

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.sample()

    def prefetch(self, depth: int = 2,
                 start_step: int = 0) -> "PrefetchSampler":
        """Assemble `depth` batches ahead on a background thread, the
        stream starting at `start_step` (a resumed run hands the restored
        step in)."""
        return PrefetchSampler(self, depth, start_step)

    def sample(self) -> dict:
        b = self.sample_at(self._step)
        self._step += 1
        return b

    def sample_at(self, step: int) -> dict:
        """The batch for `step`: float32 (B, P, P, 1) depth (2 channels
        with `cond`), color, label and an all-ones mask."""
        rng = np.random.RandomState(
            np.random.SeedSequence((self.seed, step)).generate_state(8))
        B, P = self.batch, self.patch
        dch = 1 if self.cond is None else 2
        depth = np.empty((B, P, P, dch), np.float32)
        color = np.empty((B, P, P, 1), np.float32)
        label = np.empty((B, P, P, 1), np.float32)
        for b in range(B):
            i = (rng.randint(len(self.labels)) if self._scene_p is None
                 else int(rng.choice(len(self.labels), p=self._scene_p)))
            li = rng.randint(len(self._levels))
            lv = self._levels[li]
            lab, col, deg = lv[0][i], lv[1][i], lv[2][i]
            h, w = lab.shape
            y, x = self._corner(rng, li, i, h, w)
            lp = lab[y:y + P, x:x + P].astype(np.float32) / 255.0
            cp = col[y:y + P, x:x + P].astype(np.float32) / 255.0
            dp = deg[y:y + P, x:x + P].astype(np.float32) / 255.0
            if self.collage and rng.rand() < self.collage:
                lp, cp, dp = self._collage(rng, lp, cp, dp)
            aug = self.augment if isinstance(self.augment, str) else (
                "flips" if self.augment else "none")
            if aug != "none":
                if rng.rand() < 0.5:
                    lp, cp, dp = lp[:, ::-1], cp[:, ::-1], dp[:, ::-1]
                if rng.rand() < 0.5:
                    lp, cp, dp = lp[::-1], cp[::-1], dp[::-1]
            if aug == "full":
                if rng.rand() < 0.5:   # rot90 (square patches)
                    lp, cp, dp = lp.T, cp.T, dp.T
                # photometric jitter of the guidance only
                g = rng.uniform(0.7, 1.4)
                a = rng.uniform(0.8, 1.2)
                o = rng.uniform(-0.1, 0.1)
                cp = np.clip(a * cp ** g + o, 0.0, 1.0)
                # joint range-preserving affine of depth input and label
                s = rng.uniform(0.5, 1.0)
                t = rng.uniform(0.0, 1.0 - s)
                lp = s * lp + t
                dp = s * dp + t
            depth[b, ..., 0] = dp
            if self.cond is not None:
                depth[b, ..., 1] = self.cond[i]
            color[b, ..., 0] = cp
            label[b, ..., 0] = lp
        return {"depth": depth, "color": color, "label": label,
                "mask": np.ones((B, P, P, 1), np.float32)}

    def _collage(self, rng, lp, cp, dp):
        """Paste a rectangle of another scene's (label, guidance), with the
        donor's own degraded input inside it, and repair a band of
        2 * scale pixels around the seam with the re-synthesized
        degradation of the composite label."""
        P = self.patch
        # CutMix-style rectangle: 15-45% of the patch area
        area = rng.uniform(0.15, 0.45) * P * P
        ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0)))
        rh = int(np.clip(np.sqrt(area * ar), 4, P))
        rw = int(np.clip(np.sqrt(area / ar), 4, P))
        ty = rng.randint(P - rh + 1)
        tx = rng.randint(P - rw + 1)

        j = rng.randint(len(self.labels))
        labs, cols, _ = self._levels[0]
        dl, dc = labs[j], cols[j]
        dh, dw = dl.shape
        sy, sx = self._corner(rng, 0, j, dh, dw)
        sy = min(sy, dh - rh)
        sx = min(sx, dw - rw)

        lp = lp.copy()
        cp = cp.copy()
        lp[ty:ty + rh, tx:tx + rw] = (
            dl[sy:sy + rh, sx:sx + rw].astype(np.float32) / 255.0)
        cp[ty:ty + rh, tx:tx + rw] = (
            dc[sy:sy + rh, sx:sx + rw].astype(np.float32) / 255.0)

        deg_j = self._levels[0][2][j]
        dp = dp.copy()
        dp[ty:ty + rh, tx:tx + rw] = (
            deg_j[sy:sy + rh, sx:sx + rw].astype(np.float32) / 255.0)
        lab8 = np.clip(np.rint(lp * 255.0), 0, 255).astype(np.uint8)
        resyn = synthesize_lr(lab8, self.scale).astype(np.float32) / 255.0
        band = 2 * self.scale
        seam = np.zeros((P, P), bool)
        y0, y1 = max(0, ty - band), min(P, ty + rh + band)
        x0, x1 = max(0, tx - band), min(P, tx + rw + band)
        seam[y0:y1, x0:x1] = True
        iy0, iy1 = ty + band, ty + rh - band
        ix0, ix1 = tx + band, tx + rw - band
        if iy1 > iy0 and ix1 > ix0:
            seam[iy0:iy1, ix0:ix1] = False   # the interior keeps its own
        dp[seam] = resyn[seam]
        return lp, cp, dp

    def _corner(self, rng, level: int, img: int, h: int, w: int):
        """Top-left patch corner: uniform, or (with prob edge_bias) jittered
        around a random depth-edge pixel of this image."""
        P = self.patch
        if self._edge_yx is not None and rng.rand() < self.edge_bias:
            ys, xs = self._edge_yx[level][img]
            if len(ys):
                k = rng.randint(len(ys))
                jy = rng.randint(-(P // 4), P // 4 + 1)
                jx = rng.randint(-(P // 4), P // 4 + 1)
                y = int(np.clip(ys[k] - P // 2 + jy, 0, max(0, h - P)))
                x = int(np.clip(xs[k] - P // 2 + jx, 0, max(0, w - P)))
                return y, x
        return (rng.randint(max(1, h - P + 1)),
                rng.randint(max(1, w - P + 1)))


class _WorkerError:
    """Carries an exception out of the prefetch worker thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchSampler:
    """Thread-backed sampler: `sample()` pops a pre-assembled batch.

    The worker calls `sampler.sample_at(step)` for step = start_step,
    start_step + 1, ..., so the delivered stream does not depend on thread
    scheduling or queue depth. An exception in the worker is raised from
    `sample()` (and from every later call), never swallowed.
    """

    def __init__(self, sampler: PatchSampler, depth: int = 2,
                 start_step: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._failed = None

        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    b = sampler.sample_at(step)
                    step += 1
                except Exception as e:   # raised again by sample()
                    b = _WorkerError(e)
                while not self._stop.is_set():
                    try:
                        self._q.put(b, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if isinstance(b, _WorkerError):
                    return

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def sample(self) -> dict:
        if self._failed is not None:
            raise RuntimeError(
                "PrefetchSampler worker thread failed") from self._failed
        item = self._q.get()
        if isinstance(item, _WorkerError):
            self._failed = item.exc
            raise RuntimeError(
                "PrefetchSampler worker thread failed") from item.exc
        return item

    def close(self) -> None:
        """Stop the worker and wait for it (it checks every 0.2 s)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5.0)
