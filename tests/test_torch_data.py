"""The port's PNG codec and input pipeline against cv2 and the JAX package.

The port reads and writes PNGs with zlib alone; this test may use cv2 to
write the files the codec must read and to read the files it writes.
"""
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from codon_tpu.data import io as jio
from codon_tpu.data import pipeline as jpipe

from codon_tpu_torch.data import io as tio
from codon_tpu_torch.data import pipeline as tpipe

from torch_port_common import one_torch_thread, write_scale_dir  # noqa: F401


def _image(h, w, seed=0):
    """Smooth ramps plus noise: rows that favour every PNG filter."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (xx * 3 + yy * 2 + rng.randint(0, 40, (h, w))) % 256
    return img.astype(np.uint8)


@pytest.mark.parametrize("hw", [(1, 1), (37, 29), (64, 3), (5, 300)])
def test_png_round_trip(tmp_path, hw):
    img = _image(*hw, seed=hw[0])
    path = str(tmp_path / "sub" / "a.png")
    tio.imwrite_gray(path, img)
    np.testing.assert_array_equal(tio.imread_gray(path), img)
    # and what the port writes is a PNG that cv2 reads
    np.testing.assert_array_equal(cv2.imread(path, 0), img)
    assert tpipe.png_size(path) == hw


@pytest.mark.parametrize("filt", ["NONE", "SUB", "UP", "AVG", "PAETH",
                                  "ALL"])
def test_png_reads_what_cv2_writes(tmp_path, filt):
    img = _image(41, 53, seed=1)
    path = str(tmp_path / "cv2.png")
    flag = getattr(cv2, "IMWRITE_PNG_ALL_FILTERS" if filt == "ALL"
                   else f"IMWRITE_PNG_FILTER_{filt}")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
    np.testing.assert_array_equal(tio.imread_gray(path), img)
    np.testing.assert_array_equal(tio.imread_gray(path),
                                  jio.imread_gray(path))


def _raw_png(path, ihdr, rows, extra=b""):
    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body +
                struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + extra +
            chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return data


def _encode(img, ftype):
    """Filter every row of `img` with PNG filter `ftype` (the encoder side)."""
    h, w = img.shape
    a = img.astype(np.int32)
    out = []
    for y in range(h):
        up = a[y - 1] if y else np.zeros(w, np.int32)
        left = np.concatenate([[0], a[y, :-1]])
        ul = np.concatenate([[0], up[:-1]])
        if ftype == 0:
            pred = np.zeros(w, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((a[y] - pred) & 0xFF).astype(
            np.uint8).tobytes())
    return b"".join(out)


def test_png_decodes_each_filter_type(tmp_path):
    img = _image(9, 17, seed=2)
    for ftype in range(5):
        path = str(tmp_path / f"f{ftype}.png")
        _raw_png(path, struct.pack(">IIBBBBB", 17, 9, 8, 0, 0, 0, 0),
                 _encode(img, ftype))
        np.testing.assert_array_equal(tio.imread_gray(path), img)


@pytest.mark.parametrize("case", ["rgb", "16bit", "interlaced", "bad_crc",
                                  "truncated", "not_png", "bad_filter",
                                  "short_data", "palette_chunk"])
def test_png_raises_on_what_it_does_not_handle(tmp_path, case):
    path = str(tmp_path / "x.png")
    img = _image(6, 7)
    ihdr = struct.pack(">IIBBBBB", 7, 6, 8, 0, 0, 0, 0)
    if case == "rgb":
        assert cv2.imwrite(path, np.stack([img] * 3, -1))
    elif case == "16bit":
        assert cv2.imwrite(path, img.astype(np.uint16) * 200)
    elif case == "interlaced":
        _raw_png(path, struct.pack(">IIBBBBB", 7, 6, 8, 0, 0, 0, 1),
                 _encode(img, 0))
    elif case == "bad_crc":
        data = bytearray(_raw_png(path, ihdr, _encode(img, 0)))
        data[-20] ^= 0xFF                     # inside the IDAT body
        with open(path, "wb") as f:
            f.write(bytes(data))
    elif case == "truncated":
        data = _raw_png(path, ihdr, _encode(img, 0))
        with open(path, "wb") as f:
            f.write(data[:-30])
    elif case == "not_png":
        with open(path, "wb") as f:
            f.write(b"GIF89a" + bytes(40))
    elif case == "bad_filter":
        rows = bytearray(_encode(img, 0))
        rows[0] = 9
        _raw_png(path, ihdr, bytes(rows))
    elif case == "short_data":
        _raw_png(path, ihdr, _encode(img, 0)[:-3])
    elif case == "palette_chunk":
        def chunk(t, body):
            return (struct.pack(">I", len(body)) + t + body +
                    struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
        _raw_png(path, ihdr, _encode(img, 0), extra=chunk(b"PLTE", bytes(3)))
    with pytest.raises(ValueError):
        tio.imread_gray(path)


def test_imwrite_refuses_other_arrays(tmp_path):
    with pytest.raises(ValueError):
        tio.imwrite_gray(str(tmp_path / "a.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        tio.imwrite_gray(str(tmp_path / "a.png"), np.zeros((4, 4, 3),
                                                           np.uint8))


def test_discover_and_load_match_jax(tmp_path):
    root = str(tmp_path / "CODON_X4")
    names = write_scale_dir(root, [(34, 29), (21, 30), (40, 17)])
    # an extra depth-only image is skipped (the color dir is the index)
    tio.imwrite_gray(os.path.join(root, "input_depth", "extra.png"),
                     _image(5, 5))
    assert tio.discover_pairs(root) == jio.discover_pairs(root) == names
    for n in names:
        a, b = tio.load_sample(root, n), jio.load_sample(root, n)
        for f in ("depth", "color", "label"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    os.remove(os.path.join(root, "input_label", names[0] + ".png"))
    assert tio.load_sample(root, names[0]).label is None
    assert tio.load_sample(root, names[1], with_label=False).label is None


def _assert_batches_equal(tb, jb):
    assert tb.names == jb.names and tb.sizes == jb.sizes
    for f in ("depth", "color", "mask"):
        t, j = getattr(tb, f), getattr(jb, f)
        assert (t is None) == (j is None), f
        if t is not None:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for a, b in zip(tb.labels, jb.labels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"target_batch": 4},
                                {"fixed_hw": (64, 64)}])
def test_make_batch_matches_jax(tmp_path, kw):
    root = str(tmp_path / "d")
    names = write_scale_dir(root, [(34, 29), (21, 30), (40, 17)])
    samples = [tio.load_sample(root, n) for n in names]
    tb = tpipe.make_batch(samples, 32, device="cpu", **kw)
    jb = jpipe.make_batch([jio.load_sample(root, n) for n in names], 32,
                          **kw)
    _assert_batches_equal(tb, jb)
    assert tb.depth.device.type == "cpu"


def test_make_batch_uniform_has_no_mask(tmp_path):
    root = str(tmp_path / "d")
    names = write_scale_dir(root, [(32, 64), (32, 64)])
    b = tpipe.make_batch([tio.load_sample(root, n) for n in names], 32,
                         device="cpu")
    assert b.mask is None


def test_make_batch_refuses_mismatched_label(tmp_path):
    root = str(tmp_path / "d")
    names = write_scale_dir(root, [(34, 29)])
    s = tio.load_sample(root, names[0])
    s.label = s.label[:-1]
    with pytest.raises(ValueError, match="mismatched pair"):
        tpipe.make_batch([s], 32, device="cpu")


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_batched_loader_matches_jax(tmp_path, batch_size):
    root = str(tmp_path / "d")
    names = write_scale_dir(root, [(34, 29), (21, 30), (40, 17), (34, 29),
                                   (70, 20)])
    got = list(tpipe.batched_loader(root, names, batch_size, 32,
                                    device="cpu"))
    # the JAX loader's default, pad_to_max: the one mode the port has
    want = list(jpipe.batched_loader(root, names, batch_size, 32))
    assert len(got) == len(want)
    for tb, jb in zip(got, want):
        _assert_batches_equal(tb, jb)


def test_batched_loader_hands_decode_errors_to_the_consumer(tmp_path):
    root = str(tmp_path / "d")
    names = write_scale_dir(root, [(34, 29), (34, 29), (34, 29)])
    path = os.path.join(root, "input_color", names[2] + ".png")
    with open(path, "r+b") as f:
        f.seek(40)
        f.write(b"\x00\x01\x02\x03")
    it = tpipe.batched_loader(root, names, 2, 32, device="cpu")
    assert len(next(it).names) == 2
    with pytest.raises(ValueError):
        next(it)


def test_batched_loader_pads_every_batch_to_one_shape(tmp_path):
    root = str(tmp_path / "d")
    names = write_scale_dir(root, [(70, 20), (34, 29), (21, 30), (40, 17),
                                   (33, 65)])
    got = list(tpipe.batched_loader(root, names, 2, 32, device="cpu"))
    assert [b.names for b in got] == [names[:2], names[2:4], names[4:]]
    for b in got:
        assert b.depth.shape == (2, 96, 96, 1)
        assert b.mask is not None and b.mask.shape == b.depth.shape
