"""A reader and a writer of the HDF5 subset that Keras' ``.h5`` files use,
in plain Python (numpy and the standard library; no h5py).

The reference saves its models as Keras ``.h5`` files, and the JAX package
reads and writes them with h5py and TensorFlow (denoise_gan_tpu/io/
keras_h5.py, tools/export_h5.py).  The machine with the card has neither,
so the port reads and writes the format itself, by the HDF5 file-format
specification.  Keras (2 and 3, through h5py's default
``libver="earliest"``) writes only the oldest structures, which is what
the reader takes:

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
``shape`` and reads to a numpy array by ``ds[()]`` or ``np.asarray(ds)``.
Values read as h5py gives them: arrays in the stored
byte order, ``S<n>`` bytes for fixed-length strings, objects for
variable-length ones (str in attributes, bytes in datasets); a scalar
attribute as its element, a null dataspace's as None.

The writer (``NewGroup``, ``write``) lays out the same subset as h5py
writes it for Keras: superblock version 0 (group leaf K 4, internal K 16,
h5py's), version-1 object headers in one block, old-style groups (the
links sorted by name in ``SNOD`` nodes of 8 under a group B-tree of as
many levels as they need), contiguous datasets of IEEE floats and
integers (0-d and 0-size too), and version-1 attributes: numbers,
fixed-length null-padded ``S<n>`` strings, and variable-length ASCII or
UTF-8 strings (``Strings``: one, or a 1-D array) in one ``GCOL``
collection.  An attribute past HDF5's 64 KiB message limit raises
ValueError (Keras splits such a list, keras_h5.py).
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


# ---------------------------------------------------------------------------
# the writer

LEAF_K = 4           # a symbol-table node holds 2 * LEAF_K links (h5py's)
NODE_K = 16          # a group B-tree node, 2 * NODE_K children (h5py's)
GCOL_MIN = 4096      # the least size of a global heap collection
MESSAGE_MAX = 0xFFF8  # a version-1 header message's body: 2-byte size, 8-aligned
FREE_NULL = 1        # a local heap's "no free block" (H5HL_FREE_NULL)
SNOD_SIZE = 8 + 2 * LEAF_K * 40
TREE_SIZE = 24 + 2 * NODE_K * 8 + (2 * NODE_K + 1) * 8
# a dataset's fill value message as h5py writes it (version 2: allocated
# late, the library's default value)
FILL_VALUE = bytes([2, 2, 2, 1, 0, 0, 0, 0])
_FLOATS = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
           8: (63, 52, 11, 52, 1023)}   # sign, exponent at, size, mantissa, bias


def _pad(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


class Strings:
    """An attribute of variable-length strings: one (a scalar attribute)
    or a sequence (a 1-D one), str or bytes, flagged with `charset`
    "utf-8" (what h5py writes for str) or "ascii" (for bytes)."""

    def __init__(self, value, charset: str = "utf-8"):
        if charset not in ("utf-8", "ascii"):
            raise ValueError(f"charset {charset!r}: utf-8 or ascii")
        self.scalar = isinstance(value, (str, bytes))
        values = [value] if self.scalar else list(value)
        self.values = [v if isinstance(v, bytes) else v.encode("utf-8")
                       for v in values]
        self.charset = charset


class NewGroup:
    """A group to write: ``attrs`` (written in insertion order: numpy
    numbers, ``S<n>`` arrays, ``Strings``, str), and its links to groups
    (``create_group``) and datasets (``group[path] = array``: IEEE floats
    or integers) by '/'-separated paths."""

    def __init__(self):
        self.attrs: dict = {}
        self.links: dict = {}

    def create_group(self, path: str) -> "NewGroup":
        """The group at `path`, made with its parents where missing."""
        node = self
        for part in [p for p in path.split("/") if p]:
            child = node.links.setdefault(part, NewGroup())
            if not isinstance(child, NewGroup):
                raise ValueError(f"{path!r}: {part!r} is a dataset")
            node = child
        return node

    def __setitem__(self, path: str, array) -> None:
        parent, _, name = path.strip("/").rpartition("/")
        group = self.create_group(parent)
        a = np.asarray(array)
        if a.dtype.kind not in "fiu" or a.dtype.itemsize not in (1, 2, 4, 8) \
                or (a.dtype.kind == "f" and a.dtype.itemsize == 1):
            raise ValueError(f"{path!r}: a dataset of {a.dtype} (IEEE "
                             "floats and integers only)")
        if name in group.links:
            raise ValueError(f"{path!r} exists")
        group.links[name] = a


def _number_type(dtype: np.dtype) -> bytes:
    """A datatype message (version 1) of an IEEE float or an integer."""
    big = 1 if dtype.str[0] == ">" else 0
    size = dtype.itemsize
    if dtype.kind == "f":
        sign, exp_at, exp_size, man_size, bias = _FLOATS[size]
        # bits: byte order, mantissa normalised (implied leading 1)
        return struct.pack("<BBBBIHHBBBBI", 0x11, big | 0x20, sign, 0, size,
                           0, 8 * size, exp_at, exp_size, 0, man_size, bias)
    signed = 0x08 if dtype.kind == "i" else 0
    return struct.pack("<BBBBIHH", 0x10, big | signed, 0, 0, size, 0,
                       8 * size)


def _space(shape: tuple[int, ...]) -> bytes:
    """A dataspace message (version 1): scalar for (), else simple with
    its maximum dimensions, as h5py writes them."""
    rank = len(shape)
    return struct.pack(f"<BBBB4x{2 * rank}Q", 1, rank, 1 if rank else 0, 0,
                       *shape, *shape)


class _Layout:
    """The file of a NewGroup tree: metadata (superblock, the global heap,
    headers, heaps, B-trees, symbol-table nodes) first, then the datasets'
    bytes, whose addresses are filled into their layout messages last."""

    def __init__(self, root: NewGroup):
        self.meta = bytearray(96)                 # the superblock's room
        strings = list(self._strings(root))
        if len(strings) > 0xFFFF:
            raise ValueError(f"{len(strings)} variable-length strings: one "
                             "global heap collection holds 65,535")
        self.gcol, self.n_strings = self._gcol(strings), 0
        self.data: list[tuple[int, np.ndarray]] = []
        root_addr, (btree, heap) = self._group(root, "/")
        start = len(self.meta)
        for field, a in self.data:
            struct.pack_into("<Q", self.meta, field, start)
            start += -(-a.nbytes // 8) * 8
        self.meta[:96] = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                          + struct.pack("<HHIQQQQQQIIQQ", LEAF_K, NODE_K, 0,
                                        0, UNDEFINED, start, UNDEFINED,
                                        0, root_addr, 1, 0, btree, heap))

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.meta)
            for _, a in self.data:
                f.write(a.tobytes())
                f.write(bytes(-a.nbytes % 8))

    def alloc(self, n: int) -> int:
        addr = len(self.meta)
        self.meta += bytes(-(-n // 8) * 8)
        return addr

    def put(self, addr: int, b: bytes) -> None:
        self.meta[addr:addr + len(b)] = b

    # -- the global heap ------------------------------------------------

    @staticmethod
    def _strings(group: NewGroup):
        """Every variable-length string of the tree, in _group's order."""
        for value in group.attrs.values():
            if isinstance(value, str):
                value = Strings(value)
            if isinstance(value, Strings):
                yield from value.values
        for _, child in sorted(group.links.items(),
                               key=lambda kv: kv[0].encode()):
            if isinstance(child, NewGroup):
                yield from _Layout._strings(child)

    def _gcol(self, strings: list[bytes]) -> int:
        """The collection of `strings` (object i + 1 is strings[i]), with
        the free space after them as object 0; its address (0: none)."""
        if not strings:
            return 0
        objects = b"".join(struct.pack("<HHIQ", i + 1, 0, 0, len(s))
                           + _pad(s) for i, s in enumerate(strings))
        used = 16 + len(objects)
        size = max(GCOL_MIN, used)
        if 0 < size - used < 16:
            size += 16
        if size > used:
            objects += struct.pack("<HHIQ", 0, 0, 0, size - used)
        addr = self.alloc(size)
        self.put(addr, b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + objects)
        return addr

    # -- messages -------------------------------------------------------

    def _attribute(self, name: str, value, where: str) -> bytes:
        """A version-1 attribute message."""
        if isinstance(value, str):
            value = Strings(value)
        if isinstance(value, Strings):
            cset = 1 if value.charset == "utf-8" else 0
            dtype = struct.pack("<BBBBI", 0x19, 0x01, cset, 0, 16) + \
                struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
            shape = () if value.scalar else (len(value.values),)
            raw = b""
            for s in value.values:
                self.n_strings += 1
                raw += struct.pack("<IQI", len(s), self.gcol, self.n_strings)
        else:
            a = np.asarray(value)
            if a.dtype.kind == "S":
                dtype = struct.pack("<BBBBI", 0x13, 0x01, 0, 0,
                                    a.dtype.itemsize)
            elif a.dtype.kind in "fiu":
                dtype = _number_type(a.dtype)
            else:
                raise ValueError(f"{where}: attribute {name!r} of {a.dtype} "
                                 "(numbers, S<n> and Strings only)")
            shape, raw = a.shape, np.ascontiguousarray(a).tobytes()
        key = name.encode("utf-8") + b"\0"
        space = _space(shape)
        body = (struct.pack("<BBHHH", 1, 0, len(key), len(dtype), len(space))
                + _pad(key) + _pad(dtype) + _pad(space) + raw)
        if len(body) > MESSAGE_MAX:
            raise ValueError(f"{where}: attribute {name!r} takes {len(body)} "
                             f"bytes, past an object header message's "
                             f"{MESSAGE_MAX} (split it)")
        return body

    def _header(self, messages: list[tuple[int, bytes, int]]
                ) -> tuple[int, list[int]]:
        """A version-1 object header of (type, body, flags) messages in one
        block: its address and each message body's."""
        body, at = b"", []
        for t, b, flags in messages:
            at.append(16 + len(body) + 8)
            body += struct.pack("<HHB3x", t, len(_pad(b)), flags) + _pad(b)
        addr = self.alloc(16 + len(body))
        self.put(addr, struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                                   len(body)) + body)
        return addr, [addr + a for a in at]

    # -- objects --------------------------------------------------------

    def _dataset(self, a: np.ndarray) -> int:
        layout = struct.pack("<BBQQ", 3, 1, UNDEFINED, a.nbytes)
        addr, bodies = self._header([(0x0001, _space(a.shape), 0),
                                     (0x0003, _number_type(a.dtype), 1),
                                     (0x0005, FILL_VALUE, 1),
                                     (0x0008, layout, 0)])
        if a.nbytes:
            # the layout's address field, filled in once the data is placed
            self.data.append((bodies[3] + 2, np.ascontiguousarray(a)))
        return addr

    def _group(self, group: NewGroup, where: str) -> tuple[int, tuple[int,
                                                                      int]]:
        """Lay out `group` and, after its header, its links: (header
        address, (B-tree address, local heap address))."""
        links = sorted(group.links.items(), key=lambda kv: kv[0].encode())
        heap_data, offsets = bytearray(8), {}      # offset 0: ""
        for name, _ in links:
            offsets[name] = len(heap_data)
            heap_data += _pad(name.encode("utf-8") + b"\0")
        heap = self.alloc(32 + len(heap_data))
        self.put(heap, b"HEAP\0\0\0\0" + struct.pack(
            "<QQQ", len(heap_data), FREE_NULL, heap + 32) + heap_data)
        chunks = [links[i:i + 2 * LEAF_K]
                  for i in range(0, len(links), 2 * LEAF_K)]
        snods = [self.alloc(SNOD_SIZE) for _ in chunks]
        btree = self._btree([(s, offsets[c[-1][0]])
                             for s, c in zip(snods, chunks)])
        attrs = [(0x000C, self._attribute(k, v, where), 0)
                 for k, v in group.attrs.items()]
        header, _ = self._header(
            [(0x0011, struct.pack("<QQ", btree, heap), 0)] + attrs)
        for snod, chunk in zip(snods, chunks):
            entries = b""
            for name, child in chunk:
                if isinstance(child, NewGroup):
                    addr, (cb, ch) = self._group(
                        child, where.rstrip("/") + "/" + name)
                    entries += struct.pack("<QQIIQQ", offsets[name], addr, 1,
                                           0, cb, ch)
                else:
                    entries += struct.pack("<QQII16x", offsets[name],
                                           self._dataset(child), 0, 0)
            self.put(snod, b"SNOD\x01\0" + struct.pack("<H", len(chunk))
                     + entries)
        return header, (btree, heap)

    def _btree(self, items: list[tuple[int, int]]) -> int:
        """The group B-tree over (child address, heap offset of its last
        name) items, as many levels as 2 * NODE_K children a node need;
        the root's address.  A node's first key is the previous node's
        last (the first node's: offset 0, the empty name)."""
        level = 0
        while True:
            groups = [items[i:i + 2 * NODE_K]
                      for i in range(0, len(items), 2 * NODE_K)] or [[]]
            addrs = [self.alloc(TREE_SIZE) for _ in groups]
            left = 0
            for i, (addr, node) in enumerate(zip(addrs, groups)):
                sib_l = addrs[i - 1] if i else UNDEFINED
                sib_r = addrs[i + 1] if i + 1 < len(addrs) else UNDEFINED
                body = struct.pack("<Q", left) + b"".join(
                    struct.pack("<QQ", child, key) for child, key in node)
                self.put(addr, b"TREE" + struct.pack(
                    "<BBHQQ", 0, level, len(node), sib_l, sib_r) + body)
                left = node[-1][1] if node else left
            if len(addrs) == 1:
                return addrs[0]
            items = [(a, node[-1][1]) for a, node in zip(addrs, groups)]
            level += 1


def write(path: str, root: NewGroup) -> None:
    """Write the tree under `root` (its attributes the file's root group's)
    as an HDF5 file at `path` (see the module docstring)."""
    _Layout(root).write(path)
