"""Read the JAX package's ``.ckpt`` files without JAX, flax or msgpack.

The writer is rl_games_tpu/utils/checkpoint.py (:36-58): a pickle of

    {"state_bytes": flax.serialization.to_bytes(train state),
     "weights_bytes": to_bytes({"params", "norm"}),   # where written
     "meta": {"epoch", "frame", "last_mean_rewards", ...}}

and ``to_bytes`` is msgpack of the pytree's state dict: nested maps with
string keys (a list's or tuple's elements keyed "0", "1", ..., a dataclass's
fields and a named tuple's by name), None, bools, numbers, and two of
flax's ext types: 1, an ndarray packed as the msgpack array (shape, dtype
name, C-order bytes), and 3, a numpy scalar packed alike. Arrays above 1 GiB
are split into chunks under ``__msgpack_chunked_array__``. The card's
machine has neither ``msgpack`` nor ``ml_dtypes``, so this module decodes
that format itself (``msgpack_restore``), the rest of msgpack with it, and
turns a ``bfloat16`` array into float32 by shifting its bits.

The pickle is read by an ``Unpickler`` that resolves only builtins and
numpy's scalar, dtype and array reconstructors and refuses any other global,
naming it: reading a ``.ckpt`` never imports JAX or anything else into the
port's process. ``read_jax_checkpoint`` returns the decoded trees as nested
dicts of numpy arrays (read-only views of the file's bytes, as flax's are)
and the meta dict; ``utils/jax_params`` maps them into the port's state.
"""

import importlib
import pickle
import struct

import numpy as np

from rl_games_tpu_torch.utils.checkpoint import safe_filesystem_op

# the extension the JAX package's checkpoints carry (the port's are .pth)
JAX_CHECKPOINT_EXT = ".ckpt"

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` names a JAX package checkpoint, by its extension."""
    return str(path).endswith(JAX_CHECKPOINT_EXT)


# ---------------------------------------------------------------------------
# msgpack
# ---------------------------------------------------------------------------


class _Reader:
    """A cursor over msgpack bytes; ``value()`` decodes the next object."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, {n} more wanted at {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # marker -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts no object")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data):
    """One msgpack object from ``data`` (str as str, bin as bytes, arrays as
    lists, flax's ext types 1 and 3 as numpy arrays and scalars)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return out


def _dtype_array(buffer, name: str, shape) -> np.ndarray:
    """The C-order bytes of an array of the named dtype; bfloat16 (which
    numpy lacks without ml_dtypes) widens to float32, its bits shifted into
    the high half of each float."""
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not one that flax writes for arrays (1, 3)")
    shape, name, buffer = _Reader(data).value()
    name = name.decode() if isinstance(name, bytes) else name
    arr = _dtype_array(buffer, name, tuple(shape))
    return arr if code == _EXT_NDARRAY else arr[()]


def _as_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    """flax's chunked arrays (``__msgpack_chunked_array__``) joined again."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        return np.concatenate(_as_tuple(tree["chunks"])).reshape(_as_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data):
    """flax.serialization.msgpack_restore without flax: the state dict that
    ``to_bytes`` wrote."""
    return _unchunk(unpackb(data))


# ---------------------------------------------------------------------------
# the pickle
# ---------------------------------------------------------------------------

_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex", "str", "bytes",
             "bytearray", "bool", "slice", "range"}
# numpy's reconstructors, under numpy 2's module names and numpy 1's
_NUMPY = {("multiarray", "scalar"), ("multiarray", "_reconstruct"), ("numeric", "_frombuffer")}


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves builtins' plain types and numpy's scalar, dtype and array
    reconstructors; any other global raises, naming it."""

    def find_class(self, module, name):
        if module == "builtins" and name in _BUILTINS:
            return getattr(__import__("builtins"), name)
        if module == "numpy" and name in ("dtype", "ndarray"):
            return getattr(np, name)
        parts = module.split(".")
        if len(parts) == 3 and parts[0] == "numpy" and parts[1] in ("core", "_core") \
                and (parts[2], name) in _NUMPY:
            for core in (parts[1], "_core" if parts[1] == "core" else "core"):
                try:
                    return getattr(importlib.import_module(f"numpy.{core}.{parts[2]}"), name)
                except (ImportError, AttributeError):
                    continue
        raise pickle.UnpicklingError(f"a JAX checkpoint may not name the global {module}.{name}; "
                                     "only builtins and numpy's reconstructors are read")


def read_jax_checkpoint(path: str) -> dict:
    """{'state': the train state's tree, 'weights': the {'params', 'norm'}
    tree (None where the file has none), 'meta': the meta dict}, each tree
    nested dicts of numpy arrays."""
    def read():
        with open(path, "rb") as f:
            return _RestrictedUnpickler(f).load()

    payload = safe_filesystem_op(read)
    if not isinstance(payload, dict) or "state_bytes" not in payload:
        raise ValueError(f"{path} is not a JAX package checkpoint: it has no 'state_bytes'")
    return {
        "state": msgpack_restore(payload["state_bytes"]),
        "weights": msgpack_restore(payload["weights_bytes"]) if "weights_bytes" in payload else None,
        "meta": dict(payload.get("meta") or {}),
    }
