"""Pure-python LMDB (Lightning Memory-Mapped Database) file I/O.

The reference stores training images in LMDB environments
(``codes/data/util.py:34-69`` reader; ``codes/scripts/create_lmdb.py:35-66``
writer: key = image basename, value = raw uint8 HWC bytes, ``<key>.meta`` =
``"H, W, C"``, plus a pickled ``_keys_cache.p`` key list). Rather than depend
on the ``lmdb`` C module, this module implements the LMDB on-disk format
directly — a read path that can open real,
reference-produced environments, and a write path emitting valid
environments the C library (and this reader) can open.

Format notes (LMDB file format v1, 64-bit, 4096-byte pages):

  * pages 0 and 1 are meta pages (``MDB_meta``: magic 0xBEEFC0DE, version 1,
    FREE/MAIN ``MDB_db`` descriptors, last_pg, txnid); readers use the meta
    with the higher txnid;
  * the MAIN database is a B+tree of pages: branch pages (flag 0x01) hold
    (key, child-pgno) nodes, leaf pages (flag 0x02) hold (key, value) nodes;
    values too large for a leaf node carry flag ``F_BIGDATA`` (0x01) and
    store an 8-byte pgno of an overflow page run (flag 0x04, ``mp_pages``
    pages, data contiguous after the first page's 16-byte header);
  * node layout: ``lo u16 | hi u16 | flags u16 | ksize u16 | key | data``
    where datasize = lo | hi<<16 on leaves and the child pgno spans
    lo | hi<<16 | flags<<32 on branches; page layout: 16-byte header
    (pgno u64, pad u16, flags u16, lower u16, upper u16), then a uint16
    offset array growing up and nodes packed from the page end down;
  * keys are memcmp-sorted (python ``bytes`` comparison).

Supported subset: read — any MAIN tree without DUPSORT/LEAF2 (the reference
never uses those); write — one transaction, fresh file.

A copy of ``esrganplus_tpu/data/lmdb_io.py`` (pure python, no JAX), so that
the port reads and writes the same environments byte for byte.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Tuple

PAGE_SIZE = 4096
PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")        # pad, flags, depth, branch, leaf, ovf, entries, root
_PGHDR = struct.Struct("<QHHHH")        # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")       # lo, hi, flags, ksize


def _env_file(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only view of an LMDB environment (directory or data file)."""

    def __init__(self, path: str):
        self.path = path
        with open(_env_file(path), "rb") as f:
            self._buf = f.read()
        metas = []
        for pg in (0, 1):
            off = pg * PAGE_SIZE + PAGEHDRSZ
            magic, version, _, _ = _META.unpack_from(self._buf, off)
            if magic != MAGIC:
                raise ValueError(f"{path}: not an LMDB file (bad magic in meta {pg})")
            if version != VERSION:
                raise ValueError(f"{path}: unsupported LMDB format version {version}")
            main = _DB.unpack_from(self._buf, off + _META.size + _DB.size)
            txnid = struct.unpack_from("<Q", self._buf, off + _META.size + 2 * _DB.size + 8)[0]
            metas.append((txnid, main))
        txnid, main = max(metas, key=lambda m: m[0])
        self._root = main[7]
        self.entries = main[6]

    def _page(self, pgno: int) -> Tuple[int, memoryview]:
        off = pgno * PAGE_SIZE
        _, _, flags, lower, upper = _PGHDR.unpack_from(self._buf, off)
        return flags, memoryview(self._buf)[off:off + PAGE_SIZE]

    def _overflow(self, pgno: int, size: int) -> bytes:
        off = pgno * PAGE_SIZE
        return self._buf[off + PAGEHDRSZ: off + PAGEHDRSZ + size]

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        flags, page = self._page(pgno)
        _, _, _, lower, _ = _PGHDR.unpack_from(page, 0)
        nkeys = (lower - PAGEHDRSZ) // 2
        ptrs = struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ)
        for p in ptrs:
            lo, hi, nflags, ksize = _NODEHDR.unpack_from(page, p)
            key = bytes(page[p + 8: p + 8 + ksize])
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
            else:
                dsize = lo | (hi << 16)
                if nflags & F_BIGDATA:
                    ovpg = struct.unpack_from("<Q", page, p + 8 + ksize)[0]
                    yield key, self._overflow(ovpg, dsize)
                else:
                    d0 = p + 8 + ksize
                    yield key, bytes(page[d0: d0 + dsize])

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._root == P_INVALID:
            return
        yield from self._iter_page(self._root)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def get(self, key: bytes):
        for k, v in self.items():
            if k == key:
                return v
        return None


def write_lmdb(path: str, items: Dict[bytes, bytes], mapsize: int = 0) -> None:
    """Write a fresh LMDB environment at directory ``path`` (data.mdb inside).

    Values larger than an inline node allowance go to overflow pages, exactly
    as the C library does for oversized items.
    """
    os.makedirs(path, exist_ok=True)
    ordered = sorted(items.items())
    # node max: lmdb allows ~(psize - hdr)/2 per node; stay conservative
    inline_max = 1024

    pages: Dict[int, bytes] = {}
    next_pg = 2

    def alloc(n: int = 1) -> int:
        nonlocal next_pg
        pg = next_pg
        next_pg += n
        return pg

    def page_bytes(pgno: int, flags: int, nodes: List[bytes], npages: int = 0,
                   payload: bytes = b"") -> bytes:
        if flags & P_OVERFLOW:
            hdr = struct.pack("<QHHI", pgno, 0, flags, npages)
            body = hdr + payload
            return body.ljust(npages * PAGE_SIZE, b"\0")
        lower = PAGEHDRSZ + 2 * len(nodes)
        upper = PAGE_SIZE
        buf = bytearray(PAGE_SIZE)
        offs = []
        for nd in nodes:
            upper -= len(nd) + (len(nd) & 1)  # 2-byte node alignment
            buf[upper:upper + len(nd)] = nd
            offs.append(upper)
        _PGHDR.pack_into(buf, 0, pgno, 0, flags, lower, upper)
        struct.pack_into(f"<{len(offs)}H", buf, PAGEHDRSZ, *offs)
        return bytes(buf)

    n_overflow = 0
    leaf_nodes: List[Tuple[bytes, bytes]] = []  # (key, node bytes)
    for key, val in ordered:
        if 8 + len(key) + len(val) <= inline_max:
            nd = _NODEHDR.pack(len(val) & 0xFFFF, len(val) >> 16, 0, len(key)) + key + val
        else:
            npg = -(-(PAGEHDRSZ + len(val)) // PAGE_SIZE)
            ovpg = alloc(npg)
            pages[ovpg] = page_bytes(ovpg, P_OVERFLOW, [], npages=npg, payload=val)
            n_overflow += npg
            nd = (_NODEHDR.pack(len(val) & 0xFFFF, len(val) >> 16, F_BIGDATA, len(key))
                  + key + struct.pack("<Q", ovpg))
        leaf_nodes.append((key, nd))

    # pack leaves
    leaves: List[Tuple[bytes, int]] = []  # (first key, pgno)
    cur: List[bytes] = []
    cur_first = b""
    used = 0
    for key, nd in leaf_nodes:
        need = 2 + len(nd) + (len(nd) & 1)
        if cur and PAGEHDRSZ + used + need > PAGE_SIZE:
            pg = alloc()
            pages[pg] = page_bytes(pg, P_LEAF, cur)
            leaves.append((cur_first, pg))
            cur, used = [], 0
        if not cur:
            cur_first = key
        cur.append(nd)
        used += need
    pg = alloc()
    pages[pg] = page_bytes(pg, P_LEAF, cur)
    leaves.append((cur_first, pg))

    # branch levels until a single root
    level = leaves
    depth = 1
    n_branch = 0
    while len(level) > 1:
        nxt: List[Tuple[bytes, int]] = []
        cur_nodes, cur_first, used = [], b"", 0
        for i, (key, child) in enumerate(level):
            k = b"" if not cur_nodes else key  # first child key omitted
            nd = _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                               (child >> 32) & 0xFFFF, len(k)) + k
            need = 2 + len(nd) + (len(nd) & 1)
            if cur_nodes and PAGEHDRSZ + used + need > PAGE_SIZE:
                pg = alloc()
                pages[pg] = page_bytes(pg, P_BRANCH, cur_nodes)
                n_branch += 1
                nxt.append((cur_first, pg))
                cur_nodes, used = [], 0
                nd = _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                                   (child >> 32) & 0xFFFF, 0)
                need = 2 + len(nd)
            if not cur_nodes:
                cur_first = key
            cur_nodes.append(nd)
            used += need
        pg = alloc()
        pages[pg] = page_bytes(pg, P_BRANCH, cur_nodes)
        n_branch += 1
        nxt.append((cur_first, pg))
        level = nxt
        depth += 1

    root = level[0][1]
    total_pages = next_pg
    mapsize = max(mapsize, total_pages * PAGE_SIZE, 1 << 20)

    def meta_page(pgno: int, txnid: int, with_root: bool) -> bytes:
        buf = bytearray(PAGE_SIZE)
        _PGHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        off = PAGEHDRSZ
        _META.pack_into(buf, off, MAGIC, VERSION, 0, mapsize)
        off += _META.size
        _DB.pack_into(buf, off, 0, 0, 0, 0, 0, 0, 0, P_INVALID)  # FREE db
        off += _DB.size
        if with_root:
            _DB.pack_into(buf, off, 0, 0, depth, n_branch, len(leaves),
                          n_overflow, len(ordered), root)
        else:
            _DB.pack_into(buf, off, 0, 0, 0, 0, 0, 0, 0, P_INVALID)
        off += _DB.size
        struct.pack_into("<QQ", buf, off, total_pages - 1, txnid)
        return bytes(buf)

    out = bytearray()
    out += meta_page(0, 0, with_root=False)
    out += meta_page(1, 1, with_root=True)
    for pgno in sorted(pages):  # multi-page overflow entries cover their run
        assert len(out) == pgno * PAGE_SIZE, (pgno, len(out))
        out += pages[pgno]
    assert len(out) == total_pages * PAGE_SIZE
    with open(os.path.join(path, "data.mdb"), "wb") as f:
        f.write(out)
