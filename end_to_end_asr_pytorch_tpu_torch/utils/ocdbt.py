"""A read-only OCDBT key-value store: the database format of tensorstore's
``ocdbt`` kvstore (tensorstore's documentation, "OCDBT storage
format"), in which orbax keeps the arrays of the checkpoints the JAX
package writes. No tensorstore, orbax or zstd package is needed: node
bodies are decompressed by the port's own decoder (``utils/zstd.py``).

A database directory holds ``manifest.ocdbt`` and data files under
``d/``. Every manifest, B+tree node and version tree node is a file
region of the same frame: a magic number (uint32 big-endian: manifest
``0x0cdb3a2a``, B+tree node ``0x0cdb20de``, version tree node
``0x0cdb1234``), the region's length (uint64 little-endian), the format
version (varint, 0) and the body's compression (varint: 0 none, 1 zstd),
the body, and a CRC-32C of all before it (uint32 little-endian). Integers
in a body are LEB128 varints unless said otherwise; arrays are stored a
field at a time ("column-wise").

- Manifest body: the config (16-byte uuid; ``manifest_kind``, 0 single;
  ``max_inline_value_bytes``; ``max_decoded_node_bytes``; a byte
  ``version_tree_arity_log2``; the node compression, 0 none or 1 zstd
  followed by its level as int32 little-endian), a data file table, the
  newest versions inline, and references to the version tree nodes that
  hold the older ones.
- Data file table: a count, for every file but the first the length of
  the prefix it shares with the file before, every file's suffix length
  and base path length, then the suffixes. Paths are relative to the
  database directory; a node's references index its own table.
- A version: generation number, root height, root location (data file,
  offset, length), the tree's key count, node bytes and indirect value
  bytes, and commit time (uint64 little-endian nanoseconds). A version
  tree node reference adds the generations it covers and its height;
  a version tree node holds its arity and height, a data file table, and
  versions (height 0) or references to nodes one level down.
- B+tree node: a height byte, a data file table, and its entries' keys
  (each key as the length it shares with the key before and its suffix;
  interior entries add the length of the prefix common to the whole
  subtree, which the child's keys leave out). A leaf entry has a value
  length and a kind, 0 inline (the bytes follow the node's keys) or 1 a
  reference to a data file (file, offset); an interior entry has its
  child's location and statistics.

Orbax writes one database a process, ``ocdbt.process_<i>/``, and merges
them into the directory's own manifest, whose B+tree refers to the
processes' data files. ``read_ocdbt`` reads that manifest, or, where none
was merged, every ``ocdbt.process_<i>/`` database. A field outside what
the format's version 0 defines, or a feature orbax does not use (numbered
manifests), raises ``NotImplementedError`` naming it; a damaged file
raises ``ValueError``.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from .tensorboard import crc32c
from .zstd import decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_KINDS = {MANIFEST_MAGIC: "manifest", BTREE_MAGIC: "B+tree node",
          VERSION_MAGIC: "version tree node"}


class _Cursor:
    """Reads the fields of one decompressed body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def unwrap(region: bytes, magic: int, what: str) -> bytes:
    """The decompressed body of one manifest or node region, its header
    and CRC-32C checked."""
    kind = _KINDS[magic]
    if len(region) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(region)} bytes, too short for a "
                         f"{kind}")
    got = struct.unpack(">I", region[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic 0x{got:08x}, not a {kind} "
                         f"(0x{magic:08x})")
    length = struct.unpack("<Q", region[4:12])[0]
    if length != len(region):
        raise ValueError(f"{what}: the header's length {length} is not the "
                         f"region's {len(region)}")
    crc = struct.unpack("<I", region[-4:])[0]
    if crc32c(region[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    c = _Cursor(region[:-4], what)
    c.pos = 12
    version = c.varint()
    if version != 0:
        raise NotImplementedError(f"{what}: {kind} format version {version}"
                                  "; only version 0 is read")
    compression = c.varint()
    body = region[c.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return decompress(body)
    raise NotImplementedError(f"{what}: {kind} compression format "
                              f"{compression}; only 0 (none) and 1 (zstd)")


def _data_files(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1] if paths else ""
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: data file {i} shares {prefix[i]} "
                             f"bytes with a {len(prev)}-byte path")
        path = prev[:prefix[i]] + c.take(suffix[i]).decode("utf-8")
        if base[i] > len(path):
            raise ValueError(f"{c.what}: data file {i}'s base path is "
                             "longer than its path")
        if path.startswith("/") or ".." in path.split("/"):
            raise ValueError(f"{c.what}: data file path {path!r} leaves "
                             "the database directory")
        paths.append(path)
    return paths


@dataclass(frozen=True)
class Location:
    path: str              # data file, relative to the database directory
    offset: int
    length: int


@dataclass(frozen=True)
class Version:
    generation: int
    root_height: int
    root: Location
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


@dataclass(frozen=True)
class VersionNodeRef:
    generation: int        # the newest generation under the node
    location: Location
    num_generations: int
    commit_time: int
    height: int


def _paths(c: _Cursor, files: List[str], n: int) -> List[str]:
    """``n`` data file ids, as paths."""
    ids = c.varints(n)
    for i in ids:
        if i >= len(files):
            raise ValueError(f"{c.what}: data file {i} of a "
                             f"{len(files)}-file table")
    return [files[i] for i in ids]


def _locations(c: _Cursor, files: List[str], n: int) -> List[Location]:
    paths, offsets, lengths = _paths(c, files, n), c.varints(n), c.varints(n)
    return [Location(*x) for x in zip(paths, offsets, lengths)]


def _versions(c: _Cursor, files: List[str]) -> List[Version]:
    n = c.varint()
    gens, heights = c.varints(n), list(c.take(n))
    locs = _locations(c, files, n)
    keys, tree, indirect = c.varints(n), c.varints(n), c.varints(n)
    times = c.u64s(n)
    return [Version(*v) for v in zip(gens, heights, locs, keys, tree,
                                     indirect, times)]


def _version_refs(c: _Cursor, files: List[str], n: int,
                  heights: Optional[List[int]] = None
                  ) -> List[VersionNodeRef]:
    gens = c.varints(n)
    locs = _locations(c, files, n)
    counts, times = c.varints(n), c.u64s(n)
    if heights is None:
        heights = list(c.take(n))
    return [VersionNodeRef(*r) for r in zip(gens, locs, counts, times,
                                            heights)]


@dataclass(frozen=True)
class Manifest:
    uuid: bytes
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Optional[Dict[str, object]]
    versions: List[Version]                  # inline, oldest first
    version_nodes: List[VersionNodeRef]


def parse_manifest(body: bytes, what: str) -> Manifest:
    c = _Cursor(body, what)
    uuid = c.take(16)
    kind = c.varint()
    if kind != 0:
        raise NotImplementedError(
            f"{what}: manifest_kind {kind} (numbered manifests); orbax "
            "writes the single-file kind (0)")
    inline, node_bytes = c.varint(), c.varint()
    arity = c.byte()
    method = c.varint()
    if method == 0:
        compression = None
    elif method == 1:
        compression = {"id": "zstd",
                       "level": struct.unpack("<i", c.take(4))[0]}
    else:
        raise NotImplementedError(f"{what}: compression_method {method}; "
                                  "only 0 (none) and 1 (zstd)")
    files = _data_files(c)
    versions = _versions(c, files)
    nodes = _version_refs(c, files, c.varint())
    c.done()
    return Manifest(uuid, inline, node_bytes, arity, compression, versions,
                    nodes)


class Database:
    """One OCDBT database directory, read at its newest version."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "manifest.ocdbt"
        self.manifest = parse_manifest(
            unwrap(path.read_bytes(), MANIFEST_MAGIC, str(path)), str(path))

    def region(self, loc: Location) -> bytes:
        path = self.root / loc.path
        with open(path, "rb") as f:
            f.seek(loc.offset)
            data = f.read(loc.length)
        if len(data) != loc.length:
            raise ValueError(f"{path}: {loc.length} bytes at {loc.offset} "
                             f"asked, {len(data)} there")
        return data

    def _what(self, loc: Location) -> str:
        return f"{self.root / loc.path}@{loc.offset}+{loc.length}"

    def versions(self) -> List[Version]:
        """Every version the database records, oldest first: those of the
        version tree's nodes, then the manifest's inline ones."""
        out: List[Version] = []

        def walk(ref: VersionNodeRef) -> None:
            what = self._what(ref.location)
            c = _Cursor(unwrap(self.region(ref.location), VERSION_MAGIC,
                               what), what)
            arity, height = c.byte(), c.byte()
            want = self.manifest.version_tree_arity_log2
            if arity != want:
                raise ValueError(f"{what}: arity log2 {arity}, the manifest "
                                 f"says {want}")
            if height != ref.height:
                raise ValueError(f"{what}: height {height}, its reference "
                                 f"says {ref.height}")
            files = _data_files(c)
            if height == 0:
                out.extend(_versions(c, files))
            else:
                n = c.varint()
                refs = _version_refs(c, files, n, [height - 1] * n)
                c.done()
                for r in refs:
                    walk(r)
                return
            c.done()

        for ref in self.manifest.version_nodes:
            walk(ref)
        return out + list(self.manifest.versions)

    def latest(self) -> Optional[Version]:
        if self.manifest.versions:
            return max(self.manifest.versions, key=lambda v: v.generation)
        versions = self.versions()
        return versions[-1] if versions else None

    def items(self, prefix: bytes = b"") -> Iterator[Tuple[bytes, bytes]]:
        """(key, value) of every key at the newest version that starts with
        ``prefix``, in key order."""
        v = self.latest()
        if v is None or v.num_keys == 0:
            return
        yield from self._node(v.root, v.root_height, b"", prefix)

    def _node(self, loc: Location, height: int, inherited: bytes,
              prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        what = self._what(loc)
        c = _Cursor(unwrap(self.region(loc), BTREE_MAGIC, what), what)
        got = c.byte()
        if got != height:
            raise ValueError(f"{what}: height {got}, its parent says "
                             f"{height}")
        files = _data_files(c)
        n = c.varint()
        shared = [0] + c.varints(n - 1) if n else []
        suffix = c.varints(n)
        common = c.varints(n) if height > 0 else []
        keys: List[bytes] = []
        for i in range(n):
            prev = keys[-1] if keys else b""
            if shared[i] > len(prev):
                raise ValueError(f"{what}: key {i} shares {shared[i]} bytes "
                                 f"with a {len(prev)}-byte key")
            keys.append(prev[:shared[i]] + c.take(suffix[i]))
        if height > 0:
            children = _locations(c, files, n)
            c.varints(3 * n)        # each subtree's key, node, value bytes
            c.done()
            for i, (key, child) in enumerate(zip(keys, children)):
                sub = inherited + key[:common[i]]
                nxt = inherited + keys[i + 1] if i + 1 < n else None
                # the subtree holds keys from ``key`` up to the next entry's
                if not _may_hold(inherited + key, nxt, prefix):
                    continue
                yield from self._node(child, height - 1, sub, prefix)
            return
        lengths = c.varints(n)
        kinds = list(c.take(n))
        bad = sorted(set(kinds) - {0, 1})
        if bad:
            raise NotImplementedError(f"{what}: value kind {bad[0]}; only 0 "
                                      "(inline) and 1 (indirect)")
        n_ind = kinds.count(1)
        refs = iter(zip(_paths(c, files, n_ind), c.varints(n_ind)))
        values: List[bytes] = []
        for length, kind in zip(lengths, kinds):
            if kind == 0:
                values.append(c.take(length))
            else:
                path, offset = next(refs)
                values.append(self.region(Location(path, offset, length)))
        c.done()
        for key, value in zip(keys, values):
            full = inherited + key
            if full.startswith(prefix):
                yield full, value


def _may_hold(lo: bytes, hi: Optional[bytes], prefix: bytes) -> bool:
    """Whether keys in [lo, hi) can start with ``prefix``."""
    if hi is not None and hi <= prefix:
        return False
    return lo[:len(prefix)] <= prefix


def databases(d) -> List[Database]:
    """The databases of an orbax item directory: its own merged manifest,
    else each ``ocdbt.process_<i>/``."""
    d = Path(d)
    if (d / "manifest.ocdbt").is_file():
        return [Database(d)]
    subs = sorted(p for p in d.glob("ocdbt.process_*")
                  if (p / "manifest.ocdbt").is_file())
    if not subs:
        raise FileNotFoundError(f"{d}: no manifest.ocdbt, here or in an "
                                "ocdbt.process_<i>/ directory")
    return [Database(p) for p in subs]


def read_ocdbt(d, prefix: bytes = b"") -> Dict[bytes, bytes]:
    """{key: value} of every key under ``prefix`` in the item directory
    ``d`` (``databases``)."""
    out: Dict[bytes, bytes] = {}
    for db in databases(d):
        for k, v in db.items(prefix):
            if k in out:
                raise ValueError(f"{d}: key {k!r} in two process "
                                 "databases")
            out[k] = v
    return out
