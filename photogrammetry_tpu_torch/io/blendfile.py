"""Minimal pure-Python reader for Blender .blend files (the port's copy of
photogrammetry_tpu/io/blendfile.py; numpy and the standard library only).

The reference ships its ground-truth scene only as a binary asset —
``blender/15pt_star_camera_pan/project.blend`` (SURVEY.md §4 makes
"frame/pose extraction ... part of our test-infra work").  No Blender
binary exists in the image, so this module reads the documented .blend
container format directly: file blocks + the self-describing SDNA type
catalog in the DNA1 block, from which any struct field can be located by
name.  Only plain parsing lives here; scene-level extraction (camera
trajectory, star geometry) is ``synth/blend_oracle.py``.

Format notes (public, stable since Blender 2.x):
  header   = "BLENDER" + ptr size char ('_'=4, '-'=8) + endian ('v'<, 'V'>)
             + 3-digit version
  block    = code[4] + u32 size + old memory address (ptr) + u32 sdna index
             + u32 count, then `size` bytes of data
  DNA1     = "SDNA" ("NAME" names) ("TYPE" types) ("TLEN" u16 sizes)
             ("STRC" structs of (type, name) field pairs), 4-byte aligned
Pointers in block data hold the *old* addresses; the block table maps them
back.  Field names encode shape: "*ptr", "arr[3][3]", "(*fn)()".
"""
from __future__ import annotations

import re
import struct
from typing import NamedTuple

import numpy as np


class _Field(NamedTuple):
    offset: int
    size: int
    type_name: str
    name: str          # bare name, decorations stripped
    is_pointer: bool
    shape: tuple       # array dims, () for scalars


class _Struct(NamedTuple):
    name: str
    size: int
    fields: dict      # bare name -> _Field


class Block(NamedTuple):
    code: bytes
    offset: int       # file offset of the data payload
    size: int
    old_addr: int
    sdna_index: int
    count: int


_SCALARS = {
    "char": "b", "uchar": "B", "short": "h", "ushort": "H",
    "int": "i", "uint": "I", "int64_t": "q", "uint64_t": "Q",
    "float": "f", "double": "d", "int8_t": "b",
}

_NAME_RE = re.compile(r"^(?P<ptr>\*{0,3})\(?\*?(?P<name>\w+)\)?"
                      r"(?P<dims>(\[\d+\])*)(\(\))?$")


def _parse_name(decorated: str):
    m = _NAME_RE.match(decorated)
    if not m:  # pragma: no cover - SDNA names are regular
        raise ValueError(f"unparseable SDNA name {decorated!r}")
    dims = tuple(int(x) for x in re.findall(r"\[(\d+)\]", m.group("dims")))
    is_ptr = bool(m.group("ptr")) or "(" in decorated
    return m.group("name"), is_ptr, dims


class BlendFile:
    """Random access to blocks and SDNA-typed struct fields."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self.data = fh.read()
        if self.data[:7] != b"BLENDER":
            raise ValueError(f"{path}: not a .blend file")
        self.psize = 8 if self.data[7:8] == b"-" else 4
        self.endian = "<" if self.data[8:9] == b"v" else ">"
        self.version = self.data[9:12].decode()

        self.blocks: list[Block] = []
        self.by_addr: dict[int, Block] = {}
        off = 12
        hdr = 16 + self.psize
        dna = None
        while off < len(self.data):
            code = self.data[off:off + 4]
            size, = struct.unpack_from(self.endian + "I", self.data, off + 4)
            addr, = struct.unpack_from(
                self.endian + ("Q" if self.psize == 8 else "I"),
                self.data, off + 8)
            sdna, cnt = struct.unpack_from(self.endian + "II", self.data,
                                           off + 8 + self.psize)
            if code == b"ENDB":
                break
            b = Block(code, off + hdr, size, addr, sdna, cnt)
            self.blocks.append(b)
            self.by_addr[addr] = b
            if code == b"DNA1":
                dna = b
            off += hdr + size
        if dna is None:
            raise ValueError(f"{path}: no DNA1 block")
        self._parse_sdna(dna)

    # ---------------------------------------------------------------- SDNA
    def _parse_sdna(self, blk: Block) -> None:
        d = self.data[blk.offset:blk.offset + blk.size]
        e = self.endian

        def aligned(p):
            return (p + 3) & ~3

        assert d[:4] == b"SDNA" and d[4:8] == b"NAME"
        p = 8
        n, = struct.unpack_from(e + "I", d, p)
        p += 4
        names = []
        for _ in range(n):
            end = d.index(b"\0", p)
            names.append(d[p:end].decode())
            p = end + 1
        p = aligned(p)
        assert d[p:p + 4] == b"TYPE"
        p += 4
        n, = struct.unpack_from(e + "I", d, p)
        p += 4
        types = []
        for _ in range(n):
            end = d.index(b"\0", p)
            types.append(d[p:end].decode())
            p = end + 1
        p = aligned(p)
        assert d[p:p + 4] == b"TLEN"
        p += 4
        tlens = list(struct.unpack_from(e + f"{len(types)}H", d, p))
        p = aligned(p + 2 * len(types))
        assert d[p:p + 4] == b"STRC"
        p += 4
        nstrc, = struct.unpack_from(e + "I", d, p)
        p += 4

        self.structs: dict[str, _Struct] = {}
        self._sdna_structs: list[_Struct] = []
        for _ in range(nstrc):
            t, nf = struct.unpack_from(e + "HH", d, p)
            p += 4
            fields = {}
            off = 0
            for _ in range(nf):
                ft, fn = struct.unpack_from(e + "HH", d, p)
                p += 4
                bare, is_ptr, dims = _parse_name(names[fn])
                unit = self.psize if is_ptr else tlens[ft]
                count = int(np.prod(dims)) if dims else 1
                fields[bare] = _Field(off, unit, types[ft], bare,
                                      is_ptr, dims)
                off += unit * count
            s = _Struct(types[t], tlens[t], fields)
            self.structs[types[t]] = s
            self._sdna_structs.append(s)

    # ------------------------------------------------------------- access
    def struct_of_block(self, blk: Block) -> _Struct:
        return self._sdna_structs[blk.sdna_index]

    def find_blocks(self, code: bytes) -> list[Block]:
        return [b for b in self.blocks if b.code == code]

    def _read_scalar(self, abs_off: int, type_name: str):
        fmt = _SCALARS[type_name]
        v, = struct.unpack_from(self.endian + fmt, self.data, abs_off)
        return v

    def read_field(self, base_off: int, stype: _Struct, path: str,
                   index: int = 0):
        """Read ``a.b.c`` starting at file offset ``base_off`` of a struct
        of type ``stype``.  Pointers are returned as raw addresses; arrays
        as numpy arrays; embedded structs recurse; ``index`` offsets into
        the ``index``-th element when the base is an array of structs."""
        off = base_off + index * stype.size
        parts = path.split(".")
        for i, part in enumerate(parts):
            f = stype.fields[part]
            last = i == len(parts) - 1
            if last:
                if f.is_pointer:
                    if f.shape:
                        n = int(np.prod(f.shape))
                        fmt = "Q" if self.psize == 8 else "I"
                        return np.array(struct.unpack_from(
                            self.endian + fmt * n, self.data, off + f.offset))
                    return self._read_scalar(
                        off + f.offset,
                        "uint64_t" if self.psize == 8 else "uint")
                if f.type_name in _SCALARS:
                    if f.shape:
                        n = int(np.prod(f.shape))
                        vals = struct.unpack_from(
                            self.endian + _SCALARS[f.type_name] * n,
                            self.data, off + f.offset)
                        if f.type_name == "char":
                            raw = self.data[off + f.offset:
                                            off + f.offset + n]
                            return raw.split(b"\0")[0].decode("utf-8",
                                                              "replace")
                        return np.array(vals).reshape(f.shape)
                    return self._read_scalar(off + f.offset, f.type_name)
                return (off + f.offset, self.structs[f.type_name])
            # walk into embedded struct or follow pointer
            if f.is_pointer:
                addr = self._read_scalar(
                    off + f.offset,
                    "uint64_t" if self.psize == 8 else "uint")
                if addr == 0:
                    return None
                blk = self.by_addr[addr]
                off = blk.offset
                stype = self.structs[f.type_name]
            else:
                off = off + f.offset
                stype = self.structs[f.type_name]
        raise AssertionError  # pragma: no cover

    def deref(self, addr: int) -> Block | None:
        return self.by_addr.get(addr)

    def listbase(self, first_addr: int, struct_name: str):
        """Iterate a Blender ListBase chain given its ``first`` pointer."""
        out = []
        addr = first_addr
        stype = self.structs[struct_name]
        while addr:
            blk = self.by_addr[addr]
            out.append((blk.offset, stype))
            addr = self.read_field(blk.offset, stype, "next")
        return out

    def read_string(self, addr: int) -> str:
        blk = self.by_addr[addr]
        raw = self.data[blk.offset:blk.offset + blk.size]
        return raw.split(b"\0")[0].decode()

    def read_float_array(self, addr: int, count: int) -> np.ndarray:
        blk = self.by_addr[addr]
        return np.frombuffer(self.data, dtype=self.endian + "f4",
                             count=count, offset=blk.offset).copy()
