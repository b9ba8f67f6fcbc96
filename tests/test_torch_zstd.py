"""The port's zstd decoder and CRC-32C (``native/zstd.cpp`` through
``native/zstd.py``) against ``zstandard``, on the CPU.

Bit for bit, no tolerance: every zstd frame of the committed checkpoint
``docs/quality_2000/ours_ckpt/last`` (its zarr chunks, manifests and
b-tree nodes) decodes to what ``zstandard`` decodes; so do frames
``zstandard`` makes here at levels -5, 1, 3 and 19, with and without a
content checksum and a declared size, one block or many, concatenated and
between skippable frames. Truncated, corrupt, dictionary and reserved-bit
input raises an error that names it. CRC-32C matches the check value of
RFC 3720 and every OCDBT block's stored checksum.
"""

import pathlib
import struct

import numpy as np
import pytest

from patch_toon_tpu_torch.native import zstd
from patch_toon_tpu_torch.utils import ocdbt

zstandard = pytest.importorskip("zstandard")

REPO = pathlib.Path(__file__).resolve().parents[1]
LAST = REPO / "docs" / "quality_2000" / "ours_ckpt" / "last"


def _payloads():
    rng = np.random.default_rng(0)
    floats = rng.standard_normal(70_000).astype(np.float32)
    return {"empty": b"", "one": b"x", "text": b"hello, zstd " * 3000,
            "low_entropy": rng.integers(0, 4, 200_000, np.uint8).tobytes(),
            "floats": floats.tobytes(),
            "weights": (floats * 0.01).astype(np.float32).tobytes(),
            "random": rng.integers(0, 256, 40_000, np.uint8).tobytes(),
            "mixed": b"abc" * 40_000 + rng.bytes(3000) + b"\0" * 50_000}


PAYLOADS = _payloads()


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_frames_zstandard_makes_decode_bitwise(level):
    for name, data in PAYLOADS.items():
        for checksum in (False, True):
            for size in (False, True):
                c = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=size).compress(data)
                assert zstd.decompress(c) == data, (name, checksum, size)
        # a stream: no declared size, one frame of many blocks
        obj = zstandard.ZstdCompressor(level=level).compressobj()
        c = obj.compress(data) + obj.flush()
        assert zstd.decompress(c) == data, name


def test_concatenated_and_skippable_frames():
    parts = [PAYLOADS["text"], PAYLOADS["floats"], b"", PAYLOADS["mixed"]]
    frames = [zstandard.ZstdCompressor(level=3, write_checksum=True)
              .compress(p) for p in parts]
    skip = struct.pack("<II", 0x184D2A5B, 5) + b"12345"
    data = skip + frames[0] + skip + b"".join(frames[1:]) + skip
    assert zstd.decompress(data) == b"".join(parts)
    out = np.empty(sum(map(len, parts)), np.uint8)
    assert zstd.decompress_into(data, out) == out.size
    assert out.tobytes() == b"".join(parts)
    with pytest.raises(zstd.ZstdError, match="more bytes than expected"):
        zstd.decompress_into(data, np.empty(out.size - 1, np.uint8))


def test_the_checkpoints_own_frames_decode_bitwise():
    db = ocdbt.Database(LAST)
    n = 0
    for key, val in db.items():
        if key.endswith(b"/.zarray"):
            continue
        raw = db.value(val)
        assert zstd.decompress(raw) == zstandard.ZstdDecompressor(
        ).decompressobj().decompress(raw), key
        n += 1
    assert n == 173
    blocks = [LAST / "manifest.ocdbt", LAST / "d" / next(
        (LAST / "d").iterdir()).name,
        LAST / "ocdbt.process_0" / "manifest.ocdbt"]
    for path in blocks:
        raw = path.read_bytes()
        assert zstd.crc32c(raw[:-4]) == struct.unpack("<I", raw[-4:])[0]
        body = raw[14:-4]
        assert zstd.decompress(body) == zstandard.ZstdDecompressor(
        ).decompressobj().decompress(body)


def test_crc32c_check_value_and_continuation():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    data = PAYLOADS["random"]
    assert zstd.crc32c(data[1000:], zstd.crc32c(data[:1000])) == \
        zstd.crc32c(data)


def test_xxh64_is_the_frames_checksum():
    """Every payload's checksummed frame (one block and many) is accepted,
    so the decoder's XXH64 agrees with zstandard's; a change to any byte
    of the stored checksum is refused."""
    for name, data in PAYLOADS.items():
        for level in (1, 19):
            c = zstandard.ZstdCompressor(level=level, write_checksum=True
                                         ).compress(data)
            assert zstd.decompress(c) == data, (name, level)
            for i in range(1, 5):
                bad = bytearray(c)
                bad[-i] ^= 0x01
                with pytest.raises(zstd.ZstdError, match="checksum"):
                    zstd.decompress(bytes(bad))


def test_damage_is_refused_by_name():
    data = PAYLOADS["floats"]
    c = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in (3, 5, 9, len(c) // 2, len(c) - 1):
        with pytest.raises(zstd.ZstdError, match="truncated"):
            zstd.decompress(c[:cut])
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\0" * 16)
    bad = bytearray(c)
    bad[-2] ^= 0x40  # the checksum itself
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(bad))
    hits = 0
    rng = np.random.default_rng(1)
    for i in rng.integers(12, len(c) - 4, 40):
        bad = bytearray(c)
        bad[i] ^= 0x10
        try:
            out = zstd.decompress(bytes(bad))
        except zstd.ZstdError:
            hits += 1
            continue
        assert out != data  # decoded garbage must fail the checksum
    assert hits == 40
    reserved = bytearray(c)
    reserved[4] |= 0x08
    with pytest.raises(zstd.ZstdError, match="reserved"):
        zstd.decompress(bytes(reserved))
    # the same frame naming dictionary 7 (a one-byte ID after the window)
    plain = zstandard.ZstdCompressor(level=3, write_content_size=False
                                     ).compress(PAYLOADS["text"])
    assert plain[4] & 0xE3 == 0  # no single segment, size or ID yet
    named = plain[:4] + bytes([plain[4] | 1]) + plain[5:6] + b"\x07" \
        + plain[6:]
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(named)
    assert zstd.decompress(plain) == PAYLOADS["text"]
