"""A read-only reader of the HDF5 subset that Keras' ``.h5`` files use, in
plain Python (numpy and the standard library; no h5py).

The reference saves its models as Keras ``.h5`` files, and the JAX package
reads them with h5py (denoise_gan_tpu/io/keras_h5.py).  The machine with
the card has no h5py, so the port reads the format itself, by the HDF5
file-format specification.  Keras (2 and 3, through h5py's default
``libver="earliest"``) writes only the oldest structures, which is what
this reader takes:

* superblock versions 0 and 1, 8-byte offsets and lengths;
* version-1 object headers, with their continuation blocks (0x0010);
* old-style groups: the symbol-table message (0x0011), a version-1 group
  B-tree (``TREE``, node type 0, at any depth) over symbol-table nodes
  (``SNOD``), the link names in the local heap (``HEAP``);
* dataspaces (0x0001: scalar, simple, null; 0-size too), datatypes
  (0x0003: IEEE floats and integers of either byte order, fixed- and
  variable-length strings), data layouts (0x0008: version 3, contiguous
  and compact), attributes (0x000C, versions 1-3);
* variable-length strings through the global heap collections (``GCOL``).

Anything else raises ValueError naming the structure and the file: chunked
layouts, filter pipelines, version-2 object headers (``OHDR``), link and
link-info messages, dense attributes (fractal heaps), shared or committed
datatypes, soft links, other datatype classes.  The whole tree is parsed
when the file is opened, so a file either opens whole or not at all; a
dataset's bytes are read when it is.

The API is the few calls of h5py that keras_h5.py makes: ``File(path)``
(also a context manager), and on it and on its groups ``attrs`` (a dict),
``keys()``, ``in`` and ``[name]`` ('/'-separated paths).  A dataset has
``shape`` and reads to a numpy array by ``ds[()]`` or ``np.asarray(ds)``.  Values read as h5py gives them: arrays in the stored
byte order, ``S<n>`` bytes for fixed-length strings, objects for
variable-length ones (str in attributes, bytes in datasets); a scalar
attribute as its element, a null dataspace's as None.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# messages that carry nothing this reader needs
_SKIPPED = {0x0000: "NIL", 0x0004: "fill value (old)",
            0x0005: "fill value", 0x000E: "modification time (old)",
            0x0012: "modification time", 0x0013: "comment"}
_REFUSED = {0x0002: "link info message (new-style group)",
            0x0006: "link message (new-style group)",
            0x000A: "group info message (new-style group)",
            0x000B: "filter pipeline",
            0x0015: "attribute info message (dense attributes in a "
                    "fractal heap)",
            0x0016: "object reference count message (version-2 header)"}


class Datatype:
    """A parsed datatype message: `kind` 'number', 'string' (fixed) or
    'vlen_string'; `size` the bytes an element takes in storage; `dtype`
    the numpy dtype of a number or fixed string."""

    def __init__(self, kind: str, size: int, dtype=None):
        self.kind, self.size, self.dtype = kind, size, dtype


class Dataset:
    """A dataset: its `shape` and `attrs`; ``[()]`` or ``np.asarray``
    reads it."""

    def __init__(self, file: "File", name: str, shape, datatype: Datatype,
                 storage, attrs: dict):
        self._file, self.name = file, name
        self.shape = shape              # None for a null dataspace
        self._type, self._storage = datatype, storage
        self.attrs = attrs

    def read(self) -> np.ndarray:
        shape = self.shape or ()
        n = int(np.prod(shape, dtype=np.int64))
        kind, where = self._storage
        if kind == "compact":
            raw = where
        elif n == 0:
            raw = b""
        elif where == UNDEFINED:
            raise self._file.refuse("a dataset whose storage was never "
                                    "written", self.name)
        else:
            raw = self._file.bytes_at(where, n * self._type.size, self.name)
        return self._file.elements(self._type, raw, n, self.name,
                                   text=False).reshape(shape)

    def __getitem__(self, key):
        return self.read()[key]

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype)


class Group:
    """A group: `attrs`, ``keys()``, ``in`` and ``[path]``."""

    def __init__(self, name: str, links: dict, attrs: dict):
        self.name, self._links, self.attrs = name, links, attrs

    def keys(self):
        return list(self._links)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"{path!r} not in group {self.name!r}")
            node = node._links[part]
        return node


class File(Group):
    """An HDF5 file read whole into memory and its tree parsed (see the
    module docstring); ValueError where it holds anything else."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path, "rb") as f:
            self.data = f.read()
        self._gcol: dict[int, dict[int, bytes]] = {}
        self._objects: dict[int, Group | Dataset] = {}
        base, root = self._superblock()
        self.base = base
        root_obj = self._object(root, "/", ())
        if not isinstance(root_obj, Group):
            raise self.refuse("a root object that is not a group", "/")
        super().__init__("/", root_obj._links, root_obj.attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    # -- low level --------------------------------------------------------

    def refuse(self, what: str, where: str | int) -> ValueError:
        at = f"at {where:#x}" if isinstance(where, int) else f"in {where!r}"
        return ValueError(f"{self.path}: unsupported or malformed HDF5 "
                          f"structure: {what} ({at})")

    def bytes_at(self, addr: int, n: int, where) -> bytes:
        lo = self.base + addr
        if addr == UNDEFINED or lo < 0 or lo + n > len(self.data):
            raise self.refuse(f"{n} bytes at {addr:#x} beyond the file's "
                              f"{len(self.data)} (truncated?)", where)
        return self.data[lo:lo + n]

    def _unpack(self, fmt: str, addr: int, where):
        return struct.unpack(fmt, self.bytes_at(addr, struct.calcsize(fmt),
                                                where))

    def _superblock(self) -> tuple[int, int]:
        """(base address, root object header address).  The superblock
        is at 0 or a power of two from 512 on."""
        at = 0
        while self.data[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else at * 2
            if at + 8 > len(self.data):
                raise ValueError(f"{self.path}: no HDF5 superblock "
                                 "signature (not an HDF5 file)")
        sb = self.data[at:at + 96]
        if len(sb) < 24:
            raise self.refuse("a truncated superblock", at)
        version = sb[8]
        if version not in (0, 1):
            raise self.refuse(f"superblock version {version} (a file "
                              "written with libver='latest' or later "
                              "than 1.8's defaults)", at)
        o_size, l_size = sb[13], sb[14]
        if (o_size, l_size) != (8, 8):
            raise self.refuse(f"a superblock with {o_size}-byte offsets "
                              f"and {l_size}-byte lengths (only 8 and 8)",
                              at)
        pos = at + 24 + (4 if version == 1 else 0)
        base = struct.unpack_from("<Q", self.data, pos)[0]
        # the superblock's four addresses (the base first), then the root
        # group's symbol-table entry
        return base, self._entry(pos + 32, "/")[1]

    def _entry(self, pos: int, where) -> tuple[int, int, int, bytes]:
        """A symbol-table entry at absolute `pos`: (link name offset,
        object header address, cache type, scratch pad)."""
        if pos + 40 > len(self.data):
            raise self.refuse("a truncated symbol-table entry", where)
        name_off, header, cache, _ = struct.unpack_from("<QQII", self.data,
                                                        pos)
        return name_off, header, cache, self.data[pos + 24:pos + 40]

    # -- object headers ---------------------------------------------------

    def _messages(self, addr: int, where: str) -> list[tuple[int, bytes]]:
        """The (type, body) messages of the version-1 object header at
        `addr`, continuation blocks followed."""
        head = self.bytes_at(addr, 16, where)
        if head[:4] == b"OHDR":
            raise self.refuse("a version-2 object header (OHDR)", where)
        version, _, count, _refs, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise self.refuse(f"object header version {version}", where)
        blocks = [(addr + 16, size)]
        out: list[tuple[int, bytes]] = []
        seen = set()
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            if start in seen:
                raise self.refuse("a continuation loop", where)
            seen.add(start)
            block = self.bytes_at(start, length, where)
            pos = 0
            while pos + 8 <= length and len(out) < count:
                mtype, msize, flags = struct.unpack_from("<HHB", block, pos)
                body = block[pos + 8:pos + 8 + msize]
                if len(body) != msize:
                    raise self.refuse("a message past its header block",
                                      where)
                pos += 8 + msize
                if flags & 0x02:
                    raise self.refuse(f"a shared message (type {mtype:#06x}"
                                      "; committed datatype?)", where)
                if mtype == 0x0010:
                    cont, clen = struct.unpack_from("<QQ", body)
                    blocks.append((cont, clen))
                out.append((mtype, body))
        if len(out) != count:
            raise self.refuse(f"{len(out)} of {count} header messages "
                              "found", where)
        return out

    def _object(self, addr: int, name: str, parents: tuple[int, ...]):
        if addr in parents:
            raise self.refuse("a group that contains itself", name)
        if addr in self._objects:
            return self._objects[addr]
        attrs: dict = {}
        parts: dict = {}
        for mtype, body in self._messages(addr, name):
            if mtype in _SKIPPED or mtype == 0x0010:
                continue
            if mtype in _REFUSED:
                raise self.refuse(_REFUSED[mtype], name)
            if mtype == 0x0001:
                parts["space"] = self._dataspace(body, name)
            elif mtype == 0x0003:
                parts["type"] = self._datatype(body, name)[0]
            elif mtype == 0x0008:
                parts["layout"] = self._layout(body, name)
            elif mtype == 0x000C:
                key, value = self._attribute(body, name)
                attrs[key] = value
            elif mtype == 0x0011:
                parts["table"] = struct.unpack_from("<QQ", body)
            else:
                raise self.refuse(f"header message type {mtype:#06x}", name)
        attrs = dict(sorted(attrs.items()))     # h5py's order: by name
        if "table" in parts:
            btree, heap = parts["table"]
            links = {}
            for link, child in self._group_links(btree, heap, name):
                path = name.rstrip("/") + "/" + link
                links[link] = self._object(child, path, parents + (addr,))
            obj = Group(name, links, attrs)
        elif {"space", "type", "layout"} <= set(parts):
            obj = Dataset(self, name, parts["space"], parts["type"],
                          parts["layout"], attrs)
        elif "type" in parts:
            raise self.refuse("a committed (named) datatype", name)
        else:
            raise self.refuse("an object that is neither an old-style "
                              "group nor a dataset", name)
        self._objects[addr] = obj
        return obj

    # -- groups -----------------------------------------------------------

    def _heap_data(self, heap: int, where: str) -> tuple[int, int]:
        sig, version, _, size, _free, data = self._unpack(
            "<4sB3sQQQ", heap, where)
        if sig != b"HEAP" or version != 0:
            raise self.refuse(f"a local heap that is not HEAP version 0 "
                              f"({sig!r}, {version})", where)
        return data, size

    def _name(self, heap_data: tuple[int, int], off: int, where) -> str:
        data, size = heap_data
        raw = self.bytes_at(data, size, where)
        end = raw.find(b"\0", off)
        if off >= size or end < 0:
            raise self.refuse("a link name outside its local heap", where)
        return raw[off:end].decode("utf-8")

    def _group_links(self, btree: int, heap: int, where: str):
        """(name, object header address) of every link of an old-style
        group, in the B-tree's order."""
        heap_data = self._heap_data(heap, where)
        out = []
        for snod in self._btree_leaves(btree, where, set()):
            sig, version, _, n = self._unpack("<4sBBH", snod, where)
            if sig != b"SNOD" or version != 1:
                raise self.refuse(f"a symbol-table node that is not SNOD "
                                  f"version 1 ({sig!r})", where)
            for i in range(n):
                name_off, header, cache, _ = self._entry(
                    self.base + snod + 8 + 40 * i, where)
                if cache == 2:
                    raise self.refuse("a soft link", where)
                out.append((self._name(heap_data, name_off, where), header))
        return out

    def _btree_leaves(self, node: int, where: str, seen: set) -> list[int]:
        """The SNOD addresses under the group B-tree node at `node`."""
        if node in seen:
            raise self.refuse("a B-tree loop", where)
        seen.add(node)
        sig, ntype, level, used = self._unpack("<4sBBH", node, where)
        if sig != b"TREE" or ntype != 0:
            raise self.refuse(f"a B-tree node that is not a version-1 "
                              f"group node ({sig!r}, type {ntype})", where)
        # after the 24-byte head: key 0, then (child, key) pairs
        body = self.bytes_at(node + 24, 8 + 16 * used, where)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                    for i in range(used)]
        if level == 0:
            return children
        out = []
        for child in children:
            out += self._btree_leaves(child, where, seen)
        return out

    # -- messages ---------------------------------------------------------

    def _dataspace(self, body: bytes, where: str):
        """The shape: a tuple (() for a scalar), None for a null space."""
        version, rank, flags = body[0], body[1], body[2]
        if version == 1:
            dims_at, kind = 8, (0 if rank == 0 else 1)
        elif version == 2:
            dims_at, kind = 4, body[3]
        else:
            raise self.refuse(f"dataspace version {version}", where)
        if kind == 2:
            return None
        if kind == 0:
            return ()
        if kind != 1:
            raise self.refuse(f"dataspace type {kind}", where)
        if version == 1 and flags & 0x02:
            raise self.refuse("a dataspace permutation index", where)
        return tuple(struct.unpack_from(f"<{rank}Q", body, dims_at))

    def _datatype(self, body: bytes, where: str) -> tuple[Datatype, int]:
        """The datatype and the bytes its message took."""
        cls, version = body[0] & 0x0F, body[0] >> 4
        bits = body[1] | body[2] << 8 | body[3] << 16
        size = struct.unpack_from("<I", body, 4)[0]
        if version not in (1, 2, 3):
            raise self.refuse(f"datatype version {version}", where)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            if size not in (1, 2, 4, 8):
                raise self.refuse(f"a {size}-byte integer", where)
            kind = "i" if bits & 0x08 else "u"
            return Datatype("number", size, np.dtype(f"{order}{kind}{size}")
                            ), 12
        if cls == 1:
            if bits & 0x40:
                raise self.refuse("a VAX-order float", where)
            exp_size, man_size = body[13], body[15]
            if (size, exp_size, man_size) not in ((2, 5, 10), (4, 8, 23),
                                                  (8, 11, 52)):
                raise self.refuse(f"a non-IEEE float ({size} bytes, "
                                  f"exponent {exp_size}, mantissa "
                                  f"{man_size})", where)
            return Datatype("number", size, np.dtype(f"{order}f{size}")), 20
        if cls == 3:
            return Datatype("string", size, np.dtype(f"S{size}")), 8
        if cls == 9:
            if bits & 0x0F != 1:
                raise self.refuse("a variable-length sequence (not a "
                                  "string)", where)
            base = self._datatype(body[8:], where)[1]
            return Datatype("vlen_string", size), 8 + base
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 10: "array"}
        raise self.refuse(f"datatype class {cls} "
                          f"({names.get(cls, 'unknown')})", where)

    def _layout(self, body: bytes, where: str):
        """('contiguous', address) or ('compact', raw bytes)."""
        version, cls = body[0], body[1]
        if version != 3:
            raise self.refuse(f"data layout version {version}", where)
        if cls == 0:
            n = struct.unpack_from("<H", body, 2)[0]
            return "compact", body[4:4 + n]
        if cls == 1:
            return "contiguous", struct.unpack_from("<Q", body, 2)[0]
        if cls == 2:
            raise self.refuse("a chunked data layout", where)
        raise self.refuse(f"data layout class {cls}", where)

    def _attribute(self, body: bytes, where: str):
        version = body[0]
        if version not in (1, 2, 3):
            raise self.refuse(f"attribute message version {version}", where)
        flags = body[1] if version > 1 else 0
        if flags & 0x03:
            raise self.refuse("an attribute with a shared datatype or "
                              "dataspace", where)
        name_n, type_n, space_n = struct.unpack_from("<HHH", body, 2)
        pos = 8 if version < 3 else 9

        def field(n):
            nonlocal pos
            out = body[pos:pos + n]
            pos += -(-n // 8) * 8 if version == 1 else n
            return out

        name = field(name_n).split(b"\0")[0].decode("utf-8")
        where = f"{where} attribute {name!r}"
        datatype = self._datatype(field(type_n), where)[0]
        shape = self._dataspace(field(space_n), where)
        if shape is None:
            return name, None
        n = int(np.prod(shape, dtype=np.int64))
        raw = body[pos:pos + n * datatype.size]
        if len(raw) != n * datatype.size:
            raise self.refuse("attribute data past its message", where)
        values = self.elements(datatype, raw, n, where)
        if shape == ():
            return name, values[0]
        return name, values.reshape(shape)

    # -- elements ---------------------------------------------------------

    def elements(self, datatype: Datatype, raw: bytes, n: int, where,
                 text: bool = True) -> np.ndarray:
        """The `n` elements of `datatype` stored in `raw`, a 1-D array, as
        h5py reads them: numbers in their stored byte order, fixed strings
        as ``S<n>``, variable-length strings as objects, str where `text`
        (attributes), else bytes (datasets)."""
        if datatype.kind != "vlen_string":
            return np.frombuffer(raw, datatype.dtype, n).copy()
        out = np.empty(n, dtype=object)
        for i in range(n):
            length, coll, index = struct.unpack_from("<IQI", raw, 16 * i)
            value = b"" if length == 0 else self._global(
                coll, index, where)[:length]
            out[i] = value.decode("utf-8") if text else value
        return out

    def _global(self, coll: int, index: int, where) -> bytes:
        """Object `index` of the global heap collection at `coll`."""
        if coll not in self._gcol:
            sig, version, _, size = self._unpack("<4sB3sQ", coll, where)
            if sig != b"GCOL" or version != 1:
                raise self.refuse(f"a global heap that is not GCOL version "
                                  f"1 ({sig!r})", where)
            raw = self.bytes_at(coll, size, where)
            objects, pos = {}, 16
            while pos + 16 <= size:
                idx, _refs, _, osize = struct.unpack_from("<HHIQ", raw, pos)
                if idx == 0:
                    break
                objects[idx] = raw[pos + 16:pos + 16 + osize]
                pos += 16 + -(-osize // 8) * 8
            self._gcol[coll] = objects
        try:
            return self._gcol[coll][index]
        except KeyError:
            raise self.refuse(f"global heap object {index} missing from the "
                              f"collection at {coll:#x}", where) from None
