"""HDF5 files of named numeric arrays, in plain Python and numpy.

The port reads and writes every ``.h5``/``.hdf5`` file through this module,
on every machine, so that it needs no HDF5 library. It covers the files the
pipeline makes and reads: per-slide feature bags (``features``, ``coords``),
which ``data/feature_extractor`` and ``data/tools.merge_to_hdf5_dir`` write,
and the image-bag tile stacks of ``data/image_bags`` (one dataset per tile,
or one ``images`` dataset).

:func:`write` makes the layout an HDF5 library writes by default for such a
file: a version 0 superblock, a root group indexed by a symbol table (a
version 1 B-tree over symbol nodes, names in a local heap), and for each
dataset a version 1 object header (dataspace, datatype, fill value,
contiguous layout) with its little-endian bytes after it.

:func:`read` reads the datasets of the root group of such files, including
the ones h5py writes with its defaults and the chunked ones other writers
make (``maxshape``, ``chunks``, gzip): superblock version 0 or 1,
symbol-table groups of any B-tree depth, object headers of version 1 with
continuation blocks, integer and IEEE float data stored contiguous, compact
or chunked (a version 1 B-tree chunk index of any depth, the deflate and
shuffle filters, the dataset's fill value where no chunk was written).
Anything else (superblock 2+, link-message groups, other filters such as
lzf, szip or fletcher32, strings, compound types, subgroups in the root
group) raises :class:`UnsupportedHDF5` naming what it met.
"""

from __future__ import annotations

import mmap
import struct
import zlib
from pathlib import Path
from typing import Mapping

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
LEAF_K, INTERNAL_K = 4, 16  # symbol nodes hold 2 * LEAF_K entries, B-tree nodes 2 * INTERNAL_K
ENTRY_SIZE = 40  # a symbol table entry with 8-byte offsets and lengths
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
BTREE_SIZE = 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8
HEAP_FREE_NULL = 1  # the local heap's "no free block" offset
MAX_DATASETS = 2 * LEAF_K * 2 * INTERNAL_K  # what one level-0 B-tree node indexes

# message types of the object header
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
LINK, LAYOUT, GROUP_INFO, FILTERS, CONTINUATION, SYMBOL_TABLE = 0x6, 0x8, 0xA, 0xB, 0x10, 0x11
DEFLATE, SHUFFLE = 1, 2  # the filters read
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
# IEEE floats: size -> (exponent location, exponent size, mantissa size, bias)
_FLOAT_FIELDS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


class UnsupportedHDF5(ValueError):
    """The file uses an HDF5 feature this module does not read."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ------------------------------------------------------------------ write

def _message(kind: int, body: bytes) -> bytes:
    body = body.ljust(_pad8(len(body)), b"\0")
    return struct.pack("<HHB3x", kind, len(body), 0) + body


def _object_header(messages: list[bytes]) -> bytes:
    chunk = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(chunk)) + chunk


def _datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f" and size in _FLOAT_FIELDS:
        exp_loc, exp_size, mant_size, bias = _FLOAT_FIELDS[size]
        bits = (0x20, 8 * size - 1, 0)  # mantissa normalization 2 (msb implied), sign bit
        return (struct.pack("<B3BI", 0x11, *bits, size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0, mant_size, bias))
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = (0x08 if dtype.kind == "i" else 0x00, 0, 0)
        return struct.pack("<B3BI", 0x10, *bits, size) + struct.pack("<HH", 0, 8 * size)
    raise TypeError(f"HDF5 writer: dtype {dtype} is not an integer or IEEE float type")


def _dataset_header(shape: tuple, dtype: np.dtype, address: int, nbytes: int) -> bytes:
    space = struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(struct.pack("<Q", d) for d in shape)
    fill = struct.pack("<BBBB", 2, 2, 2, 0)  # version 2, late allocation, fill if set, none set
    layout = struct.pack("<BBQQ", 3, 1, address, nbytes)  # version 3, contiguous
    return _object_header([_message(DATASPACE, space), _message(DATATYPE, _datatype(dtype)),
                           _message(FILL, fill), _message(LAYOUT, layout)])


def write(path: str | Path, datasets: Mapping[str, np.ndarray]) -> Path:
    """Write ``{name: array}`` as datasets of the root group of a new HDF5
    file at ``path`` (replacing it). Arrays are stored little-endian, C
    order, with their dtype (integers and IEEE floats)."""
    names = sorted(datasets)
    if not names or len(names) > MAX_DATASETS:
        raise ValueError(f"HDF5 writer: 1 to {MAX_DATASETS} datasets, got {len(names)}")
    arrays = [np.ascontiguousarray(np.asarray(datasets[n])) for n in names]
    arrays = [a.astype(a.dtype.newbyteorder("<")) for a in arrays]
    for name, a in zip(names, arrays):
        if not name or "/" in name or "\0" in name or name == ".":
            raise ValueError(f"HDF5 writer: bad dataset name {name!r}")
        if a.ndim == 0:
            raise ValueError(f"HDF5 writer: dataset {name!r} is a scalar; write a 1-d array")

    # local heap data: "" at offset 0, then each name null-terminated, 8-aligned
    heap_data, offsets = bytearray(8), []
    for name in names:
        offsets.append(len(heap_data))
        raw = name.encode() + b"\0"
        heap_data += raw.ljust(_pad8(len(raw)), b"\0")
    n_snods = -(-len(names) // (2 * LEAF_K))

    root_at = 96
    root_size = len(_object_header([_message(SYMBOL_TABLE, bytes(16))]))
    heap_at = root_at + root_size
    btree_at = heap_at + 32 + len(heap_data)
    snod_at = btree_at + BTREE_SIZE
    pos = snod_at + n_snods * SNOD_SIZE
    headers, data_at = [], []
    for a in arrays:
        header_at = pos
        size = len(_dataset_header(a.shape, a.dtype, 0, 0))
        at = _pad8(header_at + size) if a.nbytes else UNDEF
        headers.append((header_at, _dataset_header(a.shape, a.dtype, at, a.nbytes)))
        data_at.append(at)
        pos = _pad8((at + a.nbytes) if a.nbytes else header_at + size)
    eof = pos

    out = bytearray(eof)
    root_entry = struct.pack("<QQI4xQQ", 0, root_at, 1, btree_at, heap_at)
    out[0:96] = (SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
                 + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
                 + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF) + root_entry)
    root = _object_header([_message(SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))])
    out[root_at:root_at + len(root)] = root
    out[heap_at:btree_at] = (b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), HEAP_FREE_NULL,
                                                     heap_at + 32) + bytes(heap_data))
    # one level-0 B-tree node over the symbol nodes; key i+1 = the last name of node i
    keys = [0]
    btree = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, n_snods, UNDEF, UNDEF))
    for s in range(n_snods):
        members = list(range(s * 2 * LEAF_K, min(len(names), (s + 1) * 2 * LEAF_K)))
        keys.append(offsets[members[-1]])
        snod = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0, len(members)))
        for i in members:
            snod += struct.pack("<QQI4x16x", offsets[i], headers[i][0], 0)
        at = snod_at + s * SNOD_SIZE
        out[at:at + len(snod)] = snod
    for s in range(n_snods):
        btree += struct.pack("<QQ", keys[s], snod_at + s * SNOD_SIZE)
    btree += struct.pack("<Q", keys[n_snods])
    out[btree_at:btree_at + len(btree)] = btree
    for (header_at, header), at, a in zip(headers, data_at, arrays):
        out[header_at:header_at + len(header)] = header
        if a.nbytes:
            memoryview(out)[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    path = Path(path)
    path.write_bytes(out)
    return path


# ------------------------------------------------------------------- read

class _Reader:
    """The metadata of an HDF5 file, parsed from a read-only map of it;
    contiguous data is read from the file straight into its array."""

    def __init__(self, buf: mmap.mmap, file, path: Path) -> None:
        self.buf, self.file, self.path = buf, file, path

    def fail(self, what: str) -> UnsupportedHDF5:
        return UnsupportedHDF5(f"{self.path}: {what} is not read by utils/h5.py")

    def at(self, fmt: str, offset: int) -> tuple:
        return struct.unpack_from(fmt, self.buf, offset)

    def superblock(self) -> tuple[int, int]:
        """(base address, root object header address)."""
        start = 0
        while self.buf[start:start + 8] != SIGNATURE:
            start = 512 if start == 0 else start * 2
            if start + 8 > len(self.buf):
                raise ValueError(f"{self.path}: not an HDF5 file (no signature)")
        version = self.buf[start + 8]
        if version > 1:
            raise self.fail(f"superblock version {version}")
        size_offsets, size_lengths = self.buf[start + 13], self.buf[start + 14]
        if (size_offsets, size_lengths) != (8, 8):
            raise self.fail(f"{size_offsets}-byte offsets / {size_lengths}-byte lengths")
        p = start + 24 + (4 if version == 1 else 0)
        base, = self.at("<Q", p)
        root_header, = self.at("<Q", p + 32 + 8)
        return base, base + root_header

    def messages(self, base: int, addr: int) -> list[tuple[int, int, int, int]]:
        """(type, flags, offset, size) of each message of a version 1 object
        header, following continuation blocks."""
        version = self.buf[addr]
        if version != 1:
            sig = self.buf[addr:addr + 4]
            raise self.fail("object header version 2" if sig == b"OHDR"
                            else f"object header version {version}")
        n_msgs, _, size = self.at("<HII", addr + 2)
        chunks, out = [(addr + 16, size)], []
        while chunks and len(out) < n_msgs:
            start, size = chunks.pop(0)
            p = start
            while p + 8 <= start + size and len(out) < n_msgs:
                kind, msize, flags = self.at("<HHB", p)
                out.append((kind, flags, p + 8, msize))
                if kind == CONTINUATION:
                    cont, clen = self.at("<QQ", p + 8)
                    chunks.append((base + cont, clen))
                p += 8 + msize
        return out

    def dataset(self, base: int, addr: int, name: str) -> np.ndarray:
        shape = dtype = layout = None
        fill, fill_old, filters = None, None, []
        for kind, flags, p, size in self.messages(base, addr):
            if flags & 0x02 and kind in (DATATYPE, DATASPACE):
                raise self.fail(f"dataset {name!r}: a shared (committed) message")
            if kind == DATASPACE:
                shape = self.dataspace(p)
            elif kind == DATATYPE:
                dtype = self.datatype(p, name)
            elif kind == LAYOUT:
                layout = p
            elif kind == FILTERS:
                filters = self.filters(p, name)
            elif kind == FILL:
                fill = self.fill_value(p)
            elif kind == FILL_OLD:
                size_old, = self.at("<I", p)
                fill_old = self.buf[p + 4:p + 4 + size_old] if size_old else None
            elif kind in (SYMBOL_TABLE, LINK_INFO, LINK, GROUP_INFO):
                raise self.fail(f"the group {name!r} inside the root group")
        if shape is None or dtype is None or layout is None:
            raise self.fail(f"object {name!r} without a dataspace, datatype and layout")
        fill = fill if fill is not None else fill_old
        if fill is not None and len(fill) != dtype.itemsize:
            raise self.fail(f"dataset {name!r}: a {len(fill)}-byte fill value")
        count = int(np.prod(shape, dtype=np.int64))
        version = self.buf[layout]
        if version in (1, 2):
            rank, klass = self.buf[layout + 1], self.buf[layout + 2]
            if klass == 0:  # the dimensions, the data's size, the data
                return self.compact(layout + 8 + 4 * rank + 4, dtype, shape, count)
            data_addr, = self.at("<Q", layout + 8)
            if klass == 2:
                chunk = self.at(f"<{rank}I", layout + 16)
        elif version == 3:
            klass = self.buf[layout + 1]
            if klass == 0:  # the data's size (2 bytes), then the data
                return self.compact(layout + 4, dtype, shape, count)
            if klass == 1:
                data_addr, = self.at("<Q", layout + 2)
            elif klass == 2:
                rank, data_addr = self.at("<BQ", layout + 2)
                chunk = self.at(f"<{rank}I", layout + 11)
        else:
            raise self.fail(f"dataset {name!r}: layout message version {version}")
        if klass not in (1, 2):
            kinds = {3: "virtual"}
            raise self.fail(f"dataset {name!r}: {kinds.get(klass, f'class {klass}')} storage")
        if filters and klass != 2:
            raise self.fail(f"dataset {name!r}: a filter pipeline on unchunked storage")
        if data_addr == UNDEF or count == 0:  # never written: the fill value
            return self.filled(shape, dtype, fill)
        if klass == 2:
            if len(chunk) != len(shape) + 1 or chunk[-1] != dtype.itemsize:
                raise ValueError(f"{self.path}: dataset {name!r}: corrupt chunk dimensions")
            return self.chunked(base, base + data_addr, shape, dtype, chunk[:-1], filters,
                                fill, name)
        out = np.empty(shape, dtype)
        self.file.seek(base + data_addr)
        if self.file.readinto(out.reshape(-1).view(np.uint8)) != out.nbytes:
            raise ValueError(f"{self.path}: dataset {name!r} runs past the end of the file")
        return out

    def compact(self, p: int, dtype: np.dtype, shape: tuple, count: int) -> np.ndarray:
        raw = bytearray(self.buf[p:p + count * dtype.itemsize])
        return np.frombuffer(raw, dtype, count).reshape(shape)

    @staticmethod
    def filled(shape: tuple, dtype: np.dtype, fill: bytes | None) -> np.ndarray:
        if fill is None:
            return np.zeros(shape, dtype)
        return np.full(shape, np.frombuffer(fill, dtype)[0], dtype)

    def chunked(self, base: int, btree: int, shape: tuple, dtype: np.dtype, chunk: tuple,
                filters: list, fill: bytes | None, name: str) -> np.ndarray:
        """Assemble a chunked dataset from the chunks its B-tree indexes
        (edge chunks are stored whole and cut to the dataset's extent)."""
        out = self.filled(shape, dtype, fill)
        nbytes = int(np.prod(chunk, dtype=np.int64)) * dtype.itemsize
        for offsets, size, mask, addr in self.chunks(base, btree, len(chunk) + 1):
            raw = self.unfilter(self.buf[addr:addr + size], filters, mask, dtype)
            if len(raw) != nbytes:
                raise ValueError(f"{self.path}: dataset {name!r}: a chunk of {len(raw)} "
                                 f"bytes, not {nbytes}")
            where = tuple(slice(o, min(o + c, n)) for o, c, n in zip(offsets, chunk, shape))
            block = np.frombuffer(raw, dtype).reshape(chunk)
            out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
        return out

    def chunks(self, base: int, node: int, dims: int):
        """(offsets, stored size, filter mask, address) of each chunk under
        a version 1 B-tree node of chunks (type 1); ``dims`` counts the
        element-size dimension too."""
        if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 1:
            raise ValueError(f"{self.path}: corrupt chunk B-tree")
        level, used = self.buf[node + 5], self.at("<H", node + 6)[0]
        key = 8 + 8 * dims
        p = node + 24
        for _ in range(used):
            size, mask, *offsets = self.at(f"<II{dims}Q", p)
            child, = self.at("<Q", p + key)
            if level:
                yield from self.chunks(base, base + child, dims)
            else:
                yield offsets[:-1], size, mask, base + child
            p += key + 8

    def filters(self, p: int, name: str) -> list[tuple[int, tuple]]:
        """(id, client values) of each filter of a pipeline message, in the
        order they were applied; raises on a filter that is not read."""
        version, n = self.buf[p], self.buf[p + 1]
        if version not in (1, 2):
            raise self.fail(f"dataset {name!r}: filter pipeline message version {version}")
        q, out = p + (8 if version == 1 else 2), []
        for _ in range(n):
            fid, = self.at("<H", q)
            if version == 1 or fid >= 256:
                name_len, _, n_values = self.at("<HHH", q + 2)
                q += 8
            else:
                name_len, (_, n_values) = 0, self.at("<HH", q + 2)
                q += 6
            q += _pad8(name_len) if version == 1 else name_len
            values = self.at(f"<{n_values}I", q)
            q += 4 * (n_values + (version == 1 and n_values % 2))
            if fid not in (DEFLATE, SHUFFLE):
                raise self.fail(f"dataset {name!r}: the filter {fid} "
                                f"({_FILTER_NAMES.get(fid, 'unknown')})")
            out.append((fid, values))
        return out

    @staticmethod
    def unfilter(raw: bytes, filters: list, mask: int, dtype: np.dtype) -> bytes:
        """Undo the pipeline on one chunk, last filter first; bit i of
        ``mask`` set means filter i was skipped for this chunk."""
        for i in reversed(range(len(filters))):
            fid, values = filters[i]
            if mask >> i & 1:
                continue
            if fid == DEFLATE:
                raw = zlib.decompress(raw)
            else:  # SHUFFLE: byte k of every element was stored together
                size = values[0] if values else dtype.itemsize
                n = len(raw) // size
                body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
                raw = body.T.tobytes() + raw[n * size:]
        return raw

    def fill_value(self, p: int) -> bytes | None:
        """The fill value message's value (None: undefined or the default)."""
        version = self.buf[p]
        if version == 3:
            flags = self.buf[p + 1]
            if not flags & 0x20:
                return None
            size, = self.at("<I", p + 2)
            return self.buf[p + 6:p + 6 + size] or None
        if version == 2 and not self.buf[p + 3]:
            return None
        size, = self.at("<I", p + 4)
        return self.buf[p + 8:p + 8 + size] or None

    def dataspace(self, p: int) -> tuple:
        version, rank = self.buf[p], self.buf[p + 1]
        if version == 1:
            dims = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:
                raise self.fail("a null dataspace")
            dims = p + 4
        else:
            raise self.fail(f"dataspace message version {version}")
        return tuple(self.at(f"<{rank}Q", dims)) if rank else ()

    def datatype(self, p: int, name: str) -> np.dtype:
        klass, version = self.buf[p] & 0x0F, self.buf[p] >> 4
        bits, size = self.buf[p + 1], self.at("<I", p + 4)[0]
        order = ">" if bits & 1 else "<"
        if klass == 0:
            offset, precision = self.at("<HH", p + 8)
            if size in (1, 2, 4, 8) and offset == 0 and precision == 8 * size:
                return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        elif klass == 1 and size in _FLOAT_FIELDS and not bits & 0x40:
            exp_loc, exp_size, _, mant_size, bias = self.at("<BBBBI", p + 12)
            if (exp_loc, exp_size, mant_size, bias) == _FLOAT_FIELDS[size]:
                return np.dtype(f"{order}f{size}")
        kinds = {0: "integer", 1: "float", 2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                 6: "compound", 7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
        raise self.fail(f"dataset {name!r}: the {kinds.get(klass, klass)} datatype "
                        f"(class {klass}, version {version}, {size} bytes)")

    def group_entries(self, base: int, header: int) -> list[tuple[str, int]]:
        """(name, object header address) of each member of a symbol-table group."""
        stab = None
        for kind, _, p, _ in self.messages(base, header):
            if kind == SYMBOL_TABLE:
                stab = self.at("<QQ", p)
            elif kind in (LINK_INFO, LINK):
                raise self.fail("a group indexed by link messages (new-style group)")
        if stab is None:
            raise self.fail("a root group without a symbol table")
        btree, heap = stab
        if self.buf[base + heap:base + heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: corrupt local heap")
        heap_data, = self.at("<Q", base + heap + 24)
        entries: list[tuple[str, int]] = []
        self._walk(base, base + btree, base + heap_data, entries)
        return entries

    def _walk(self, base: int, node: int, heap_data: int, entries: list) -> None:
        sig = self.buf[node:node + 4]
        if sig == b"SNOD":
            count, = self.at("<H", node + 6)
            for i in range(count):
                name_off, header = self.at("<QQ", node + 8 + i * ENTRY_SIZE)
                end = self.buf.find(b"\0", heap_data + name_off)
                if end < 0:
                    raise ValueError(f"{self.path}: corrupt local heap")
                entries.append((self.buf[heap_data + name_off:end].decode(), base + header))
            return
        if sig != b"TREE" or self.buf[node + 4] != 0:
            raise ValueError(f"{self.path}: corrupt group B-tree")
        used, = self.at("<H", node + 6)
        for i in range(used):
            child, = self.at("<Q", node + 24 + 8 + 16 * i)
            self._walk(base, base + child, heap_data, entries)


def read(path: str | Path) -> dict[str, np.ndarray]:
    """Every dataset of the root group of the HDF5 file at ``path``, by
    name (in name order), as numpy arrays of the stored dtype and shape."""
    path = Path(path)
    with open(path, "rb") as f:
        if path.stat().st_size < len(SIGNATURE):
            raise ValueError(f"{path}: not an HDF5 file (no signature)")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            reader = _Reader(buf, f, path)
            base, root = reader.superblock()
            return {name: reader.dataset(base, header, name)
                    for name, header in sorted(reader.group_entries(base, root))}
