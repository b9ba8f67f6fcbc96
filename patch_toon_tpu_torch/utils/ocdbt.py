"""A reader of OCDBT key-value databases, the store under an Orbax
checkpoint (tensorstore's ``ocdbt`` kvstore), without tensorstore.

Layout, as tensorstore writes it at format version 0:

- Every manifest and b-tree node is one encoded block: a 4-byte big-endian
  magic (``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node), its whole
  length as a little-endian uint64, the format version and the compression
  (0 none, 1 zstd) as varints, the body, and the CRC-32C of everything
  before it (little-endian). The checksum is verified on every block.
- Integers are LEB128 varints unless said otherwise; arrays are stored
  column by column.
- A manifest body: the config (16-byte uuid, manifest kind, the largest
  inline value, the largest decoded node, the version tree's arity as
  log2 in one byte, the compression and, for zstd, its level as a 4-byte
  integer), a data-file table, then the version tree's leaf: the count,
  then per version the generation number, the root's height (one byte),
  its location (file, offset, length), its statistics (keys, tree bytes,
  indirect value bytes) and the commit time (uint64), then the count of
  version-tree interior nodes. The newest version is the last.
- A data-file table: the count, the length each path shares with the one
  before it (from the second on), each path's remaining length, each base
  path's length, then the path bytes. A file is ``base_path +
  relative_path`` under the database's directory.
- A node body: its height (one byte; 0 a leaf) and its data-file table,
  then its entries: the count, the shared prefix of each key with the one
  before it (from the second on), each key's remaining length, for an
  interior node each entry's subtree common prefix length, then the key
  bytes. A leaf then holds each value's length, its kind (0 inline, 1
  indirect), the file and offset of each indirect value, and the inline
  values' bytes; an interior node holds each child's location and
  statistics. A child's keys follow the parent entry key's first
  ``subtree_common_prefix_length`` bytes.

Orbax writes one such database per process (``ocdbt.process_N/``) and a
top-level manifest whose tree refers to the processes' data files, so the
top-level database alone reads every key. The single-file manifest kind is
read; a numbered manifest, a version tree with interior nodes, another
format version or compression is refused by name.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from patch_toon_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root


class OcdbtError(ValueError):
    """A database the reader refuses or finds damaged."""


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.b, self.p, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.p + n > len(self.b):
            raise OcdbtError(f"{self.what} is truncated")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            self._need(1)
            c = self.b[self.p]
            self.p += 1
            out |= (c & 0x7F) << shift
            if c < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what} has a varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.p += 1
        return self.b[self.p - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.p += n
        return self.b[self.p - n:self.p]


def _decode_block(data: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, its checksum verified."""
    if len(data) < 18:
        raise OcdbtError(f"{what} is truncated ({len(data)} bytes)")
    got_magic, length = struct.unpack_from(">I", data)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what} has magic {got_magic:#010x}, not "
                         f"{magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what} says {length} bytes, has {len(data)}")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if zstd.crc32c(data[:-4]) != want:
        raise OcdbtError(f"{what} fails its CRC-32C checksum")
    r = _Reader(data[:-4], what)
    r.p = 12
    version, compression = r.varint(), r.varint()
    if version != FORMAT_VERSION:
        raise OcdbtError(f"{what} is OCDBT format version {version}; the "
                         f"reader takes version {FORMAT_VERSION}")
    body = data[r.p:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, what)
    raise OcdbtError(f"{what} uses compression {compression}; the reader "
                     "takes 0 (none) and 1 (zstd)")


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    shared = [0] + r.varints(max(n - 1, 0))
    rest = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError(f"{r.what} has a bad data-file table")
        prev = prev[:shared[i]] + r.raw(rest[i])
        if base[i] > len(prev):
            raise OcdbtError(f"{r.what} has a bad data-file table")
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    shared = [0] + r.varints(max(n - 1, 0))
    rest = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OcdbtError(f"{r.what} has a bad key prefix")
        prev = prev[:shared[i]] + r.raw(rest[i])
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class Ref:
    """A byte range of a data file."""
    path: str
    offset: int
    length: int


@dataclass
class Version:
    generation: int
    height: int
    root: Optional[Ref]  # None: the empty tree


class Database:
    """The newest version of the OCDBT database in ``directory``."""

    def __init__(self, directory):
        self.directory = Path(directory)
        path = self.directory / "manifest.ocdbt"
        what = str(path)
        try:
            raw = path.read_bytes()
        except OSError as e:
            raise OcdbtError(f"{what} cannot be read: {e}") from e
        r = _Reader(_decode_block(raw, MANIFEST_MAGIC, what), what)
        r.raw(16)  # the database's uuid
        kind = r.varint()
        r.varints(2)  # the largest inline value and decoded node
        arity = r.u8()
        method = r.varint()
        if method == 1:
            r.raw(4)  # the zstd level
        elif method != 0:
            raise OcdbtError(f"{what} configures compression {method}; the "
                             "reader takes 0 (none) and 1 (zstd)")
        if kind != 0:
            raise OcdbtError(f"{what} is a numbered manifest (kind {kind}); "
                             "the reader takes the single-file kind 0")
        files = _file_table(r)
        n = r.varint()
        gens, heights = r.varints(n), [r.u8() for _ in range(n)]
        refs = self._refs(r, n, files)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
        r.raw(8 * n)  # commit times
        if r.varint() != 0:
            raise OcdbtError(f"{what} has version-tree interior nodes (more "
                             f"than {1 << arity} versions); the reader takes "
                             "an inline version tree")
        self.versions = [Version(gens[i], heights[i], refs[i])
                         for i in range(n)]
        if not self.versions:
            raise OcdbtError(f"{what} has no version")
        self._nodes: Dict[Tuple[Ref, int], tuple] = {}

    def _refs(self, r: _Reader, n: int, files: List[str]
              ) -> List[Optional[Ref]]:
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        out: List[Optional[Ref]] = []
        for i in range(n):
            if offsets[i] == MISSING:
                out.append(None)
                continue
            if ids[i] >= len(files):
                raise OcdbtError(f"{r.what} names data file {ids[i]} of "
                                 f"{len(files)}")
            out.append(Ref(files[ids[i]], offsets[i], lengths[i]))
        return out

    @property
    def version(self) -> Version:
        return self.versions[-1]

    def read_range(self, ref: Ref) -> bytes:
        """The bytes of ``ref``'s range of its data file."""
        path = os.path.join(self.directory, ref.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtError(f"{path} is truncated: {ref.length} bytes at "
                             f"{ref.offset} asked, {len(data)} read")
        return data

    def _node(self, ref: Ref, height: int):
        """A node's (keys, subtree common prefix lengths, children or
        values), decoded once per database object."""
        got = self._nodes.get((ref, height))
        if got is None:
            got = self._nodes[(ref, height)] = self._decode_node(ref, height)
        return got

    def _decode_node(self, ref: Ref, height: int):
        what = f"{self.directory / ref.path}@{ref.offset}"
        r = _Reader(_decode_block(self.read_range(ref), NODE_MAGIC, what),
                    what)
        got = r.u8()
        if got != height:
            raise OcdbtError(f"{what} has height {got}, {height} expected")
        files = _file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            children = self._refs(r, n, files)
            r.varints(3 * n)  # statistics
            return keys, common, children
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what} has a value kind other than 0 and 1")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        values: List[object] = [None] * n
        for j, i in enumerate(indirect):
            if ids[j] >= len(files):
                raise OcdbtError(f"{what} names data file {ids[j]} of "
                                 f"{len(files)}")
            values[i] = Ref(files[ids[j]], offsets[j], lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                values[i] = r.raw(lengths[i])
        return keys, None, values

    def _walk(self, ref: Optional[Ref], height: int, prefix: bytes,
              lo: bytes) -> Iterator[Tuple[bytes, object]]:
        """(key, inline bytes or Ref) of every key >= lo under ``ref``,
        in order."""
        if ref is None:
            return
        keys, common, items = self._node(ref, height)
        if height == 0:
            for k, v in zip(keys, items):
                key = prefix + k
                if key >= lo:
                    yield key, v
            return
        for i, (k, child) in enumerate(zip(keys, items)):
            # skip a subtree whose successor starts at or below lo
            if i + 1 < len(keys) and prefix + keys[i + 1] <= lo:
                continue
            yield from self._walk(child, height - 1, prefix + k[:common[i]],
                                  lo)

    def items(self, prefix: bytes = b"") -> Iterator[Tuple[bytes, object]]:
        """(key, inline bytes or :class:`Ref`) for each key that starts
        with ``prefix``, in key order."""
        prefix = prefix.encode() if isinstance(prefix, str) else prefix
        v = self.version
        for key, val in self._walk(v.root, v.height, b"", prefix):
            if not key.startswith(prefix):
                return
            yield key, val

    def list(self, prefix: bytes = b"") -> List[bytes]:
        """Every key that starts with ``prefix``, in order."""
        return [k for k, _ in self.items(prefix)]

    def value(self, val) -> bytes:
        """An item's value: inline bytes as they are, a Ref read."""
        return val if isinstance(val, bytes) else self.read_range(val)

    def read(self, key) -> Optional[bytes]:
        """The value of ``key``, or None when it is absent."""
        key = key.encode() if isinstance(key, str) else key
        for k, v in self.items(key):
            return self.value(v) if k == key else None
        return None
