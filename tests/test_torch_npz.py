"""The sweep's shard writer (``sos_rt_tpu_torch/npz.py``) against
``numpy.savez_compressed``, on the CPU.

Each case writes one file of two members, ``x`` (the case's array: the
dtypes and ranks a shard holds, an empty member, and one over 3 MiB, so
that it spans several deflate blocks) and a small ``n``: ``numpy.load``
reads them back equal, ``zipfile`` finds every CRC right, the file is the
size of ``numpy.savez_compressed``'s (byte for byte where each member fits
in one block), its bytes do not depend on the pool's size, a flipped byte
in ``x``'s data makes reading ``x`` fail, and the zip64 records read back.
"""
import io
import os
import zipfile
import zlib

import numpy as np
import pytest

from sos_rt_tpu_torch import npz


def _smooth(rng, shape):
    """Rows like a shard's radiances: a slow walk along the last axis."""
    return (1 + np.cumsum(rng.normal(size=shape) * 1e-3, axis=-1)).astype(np.float32)


CASES = {
    "f32_2d": lambda rng: _smooth(rng, (64, 128)),
    "i32_1d": lambda rng: rng.integers(1, 40, 500).astype(np.int32),
    "bool_1d": lambda rng: rng.random(500) < 0.9,
    "f32_3d_orders": lambda rng: _smooth(rng, (16, 40, 128)),
    "empty_2d": lambda rng: np.zeros((0, 128), np.float32),
    "f32_over_3mib": lambda rng: _smooth(rng, (7000, 128)),
}
ONE_BLOCK = [c for c in CASES if c != "f32_over_3mib"]


def _arrays(case):
    return {"x": CASES[case](np.random.default_rng(7)), "n": np.arange(10, dtype=np.int32)}


def _npy_len(arr):
    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr)
    return buf.tell()


def _save(path, arrays, monkeypatch=None, cores=None):
    if cores is not None:
        monkeypatch.setattr(npz.os, "sched_getaffinity", lambda pid: set(range(cores)))
    with npz.NpzWriter() as w:
        w.save(str(path), **arrays)
    return w


@pytest.mark.parametrize("case", CASES)
def test_npz_reads_back(tmp_path, case):
    arrays = _arrays(case)
    _save(tmp_path / "a.npz", arrays)
    with zipfile.ZipFile(tmp_path / "a.npz") as z:
        assert z.testzip() is None
        assert z.namelist() == ["x.npy", "n.npy"]
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_DEFLATED}
    with np.load(tmp_path / "a.npz") as f:
        assert f.files == ["x", "n"]
        for k, v in arrays.items():
            assert f[k].dtype == v.dtype and f[k].shape == v.shape
            np.testing.assert_array_equal(f[k], v)


@pytest.mark.parametrize("case", CASES)
def test_npz_size_near_savez(tmp_path, case):
    arrays = _arrays(case)
    _save(tmp_path / "a.npz", arrays)
    np.savez_compressed(tmp_path / "b.npz", **arrays)
    a, b = os.path.getsize(tmp_path / "a.npz"), os.path.getsize(tmp_path / "b.npz")
    assert abs(a - b) <= 0.005 * b


@pytest.mark.parametrize("case", ONE_BLOCK)
def test_npz_one_block_is_savez(tmp_path, case):
    """Where each member fits in one block the file is savez_compressed's."""
    arrays = _arrays(case)
    _save(tmp_path / "a.npz", arrays)
    np.savez_compressed(tmp_path / "b.npz", **arrays)
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()


@pytest.mark.parametrize("case", CASES)
def test_npz_same_bytes_any_pool(tmp_path, monkeypatch, case):
    arrays = _arrays(case)
    one = _save(tmp_path / "one.npz", arrays, monkeypatch, cores=1)
    four = _save(tmp_path / "four.npz", arrays, monkeypatch, cores=4)
    assert (one.threads, four.threads) == (1, 4)
    assert one.blocks == four.blocks
    assert (tmp_path / "one.npz").read_bytes() == (tmp_path / "four.npz").read_bytes()


@pytest.mark.parametrize("case", CASES)
def test_npz_blocks_counted(tmp_path, case):
    arrays = _arrays(case)
    w = _save(tmp_path / "a.npz", arrays)
    assert w.threads == len(os.sched_getaffinity(0))
    assert w.blocks == sum(-(-_npy_len(v) // npz.BLOCK) for v in arrays.values())
    if case == "f32_over_3mib":
        assert w.blocks > len(arrays)


@pytest.mark.parametrize("case", CASES)
def test_npz_crc_catches_flipped_byte(tmp_path, case):
    arrays = _arrays(case)
    path = tmp_path / "a.npz"
    _save(path, arrays)
    with zipfile.ZipFile(path) as z:
        info = z.getinfo("x.npy")
    # the local header: 30 bytes, the name, the 20-byte zip64 extra field
    start = info.header_offset + 30 + len(info.filename) + 20
    data = bytearray(path.read_bytes())
    data[start + info.compress_size // 2] ^= 0x10
    path.write_bytes(bytes(data))
    with np.load(path) as f:
        np.testing.assert_array_equal(f["n"], arrays["n"])
        with pytest.raises((zipfile.BadZipFile, zlib.error, ValueError)):
            f["x"]


def test_npz_zip64_records(tmp_path, monkeypatch):
    """Sizes, offsets and the central directory past the zip64 limit (the
    limit lowered) take zipfile's zip64 fields and records."""
    monkeypatch.setattr(npz, "ZIP64_LIMIT", 64)
    arrays = {"x": _smooth(np.random.default_rng(3), (40, 128)), "n": np.arange(10)}
    _save(tmp_path / "a.npz", arrays)
    raw = (tmp_path / "a.npz").read_bytes()
    assert b"PK\x06\x06" in raw and b"PK\x06\x07" in raw
    with zipfile.ZipFile(tmp_path / "a.npz") as z:
        assert z.testzip() is None
    with np.load(tmp_path / "a.npz") as f:
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k], v)
