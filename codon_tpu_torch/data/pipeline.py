"""Batched, prefetching host -> device input pipeline.

  * every batch padded to ONE dataset-wide shape, a multiple of 32, with a
    validity mask (masked convs keep results per-image exact);
  * a short batch is filled up by repeating its last sample, so every batch
    has one shape; `Batch.names` lists the real entries only;
  * a background thread decodes and stages the next batches in pinned host
    memory and copies them to the device with non_blocking=True.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import struct
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from codon_tpu_torch.core.device import resolve_device
from codon_tpu_torch.data.io import Sample, load_sample


@dataclasses.dataclass
class Batch:
    names: List[str]
    depth: torch.Tensor            # (B, H, W, 1) float32 in [0, 1]
    color: torch.Tensor            # (B, H, W, 1)
    mask: Optional[torch.Tensor]   # (B, H, W, 1), None if no padding
    sizes: List[tuple]             # original (h, w) per image
    labels: List[Optional[np.ndarray]]  # uint8 host arrays
    # (B, H, W, 1) float32 in [0, 255], padded, on the device; None when
    # any sample lacks a label
    label_dev: Optional[torch.Tensor] = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: through pinned memory, without waiting,
    for the card."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_batch(samples: Sequence[Sample], pad_multiple: int = 32,
               device="cuda", target_batch: int = 0,
               fixed_hw: Optional[tuple] = None) -> Batch:
    device = resolve_device(device)
    real = len(samples)
    if target_batch > real:
        samples = list(samples) + [samples[-1]] * (target_batch - real)
    hs = [s.depth.shape[0] for s in samples]
    ws = [s.depth.shape[1] for s in samples]
    if fixed_hw is not None:
        H, W = fixed_hw
    else:
        H = _round_up(max(hs), pad_multiple)
        W = _round_up(max(ws), pad_multiple)
    B = len(samples)
    depth = np.zeros((B, H, W, 1), np.float32)
    color = np.zeros((B, H, W, 1), np.float32)
    mask = np.zeros((B, H, W, 1), np.float32)
    have_labels = all(s.label is not None for s in samples)
    label = np.zeros((B, H, W, 1), np.float32) if have_labels else None
    uniform = all(h == H and w == W for h, w in zip(hs, ws))
    for i, s in enumerate(samples):
        h, w = s.depth.shape
        if s.label is not None and s.label.shape != (h, w):
            raise ValueError(f"{s.name}: label {s.label.shape} != depth "
                             f"{(h, w)}: mismatched pair")
        depth[i, :h, :w, 0] = s.depth.astype(np.float32) / 255.0
        color[i, :h, :w, 0] = s.color.astype(np.float32) / 255.0
        mask[i, :h, :w, 0] = 1.0
        if have_labels:
            label[i, :h, :w, 0] = s.label
    return Batch(
        names=[s.name for s in samples[:real]],
        depth=to_device(depth, device), color=to_device(color, device),
        mask=None if uniform else to_device(mask, device),
        sizes=list(zip(hs, ws)),
        labels=[s.label for s in samples],
        label_dev=to_device(label, device) if have_labels else None,
    )


def padded_hw(sizes, pad_multiple: int = 32) -> tuple:
    """The one padded (H, W) of images of `sizes`, [(h, w), ...]: the
    largest of each axis, rounded up to pad_multiple."""
    return (_round_up(max(h for h, _ in sizes), pad_multiple),
            _round_up(max(w for _, w in sizes), pad_multiple))


def png_size(path: str) -> tuple:
    """(h, w) from the PNG IHDR header: 24 bytes, no decode."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def batched_loader(scale_dir: str, names: Sequence[str], batch_size: int = 1,
                   pad_multiple: int = 32, prefetch: int = 2,
                   with_label: bool = True,
                   device="cuda") -> Iterator[Batch]:
    """Yield device-resident Batches, cut in order and all padded to one
    dataset-wide shape; decode and transfer run in a worker thread
    `prefetch` batches ahead of compute."""
    device = resolve_device(device)
    hw = [png_size(os.path.join(scale_dir, "input_depth", n + ".png"))
          for n in names]
    fixed_hw = padded_hw(hw, pad_multiple)
    chunks = [list(names[i:i + batch_size])
              for i in range(0, len(names), batch_size)]
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        # timed put: a consumer that abandons the generator sets `stop`,
        # and the worker sees it instead of blocking on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for chunk in chunks:
                if stop.is_set():
                    return
                samples = [load_sample(scale_dir, n, with_label)
                           for n in chunk]
                if not put(make_batch(samples, pad_multiple, device,
                                      target_batch=batch_size,
                                      fixed_hw=fixed_hw)):
                    return
            put(done)
        except Exception as e:  # hand decode errors to the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        while True:  # unblock a worker mid-put
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
