"""The safetensors file format, read and written with torch alone.

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (byte
offsets into the data that follows; an optional ``"__metadata__"`` maps
strings to strings), then the raw little-endian bytes of every tensor. The
published HF checkpoints and the port's artifacts (``models.convert``) are
such files, one or more a directory; a sharded directory may carry
``model.safetensors.index.json`` (``{"weight_map": {name: file}}``).

``open_file`` reads lazily: the header at once, a tensor's bytes when
``get`` asks for it, as a tensor over a copy-on-write ``mmap`` of the file
(no read until its pages are touched; writing to it never reaches the
file). ``save_file`` writes tensors of the dtypes below bit for bit.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from collections.abc import Mapping

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I32": torch.int32, "I64": torch.int64,
          "U8": torch.uint8, "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


class SafeFile:
    """One safetensors file: ``keys()``, ``dtype(k)``, ``shape(k)``,
    ``metadata()`` from the header and ``get(k)`` from the mmap."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self._meta = header.pop("__metadata__", None) or {}
        self._entries = header
        self._base = 8 + n
        self._mm = None

    def keys(self):
        return list(self._entries)

    def metadata(self) -> dict:
        return dict(self._meta)

    def dtype(self, key: str) -> torch.dtype:
        return DTYPES[self._entries[key]["dtype"]]

    def shape(self, key: str) -> tuple:
        return tuple(self._entries[key]["shape"])

    def get(self, key: str) -> torch.Tensor:
        ent = self._entries[key]
        dtype, shape = DTYPES[ent["dtype"]], tuple(ent["shape"])
        begin, end = ent["data_offsets"]
        count = _numel(shape)
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        if self._mm is None:
            with open(self.path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        offset = self._base + begin
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"{self.path}: {key} holds {end - begin} bytes for "
                             f"{count} x {itemsize}")
        if offset % itemsize:
            # a writer that does not align its tensors: read through bytes
            raw = torch.frombuffer(self._mm, dtype=torch.uint8,
                                   count=end - begin, offset=offset)
            return raw.clone().view(dtype).reshape(shape)
        return torch.frombuffer(self._mm, dtype=dtype, count=count,
                                offset=offset).reshape(shape)


def open_file(path: str) -> SafeFile:
    return SafeFile(path)


def _raw_bytes(t: torch.Tensor):
    """A contiguous CPU tensor's bytes as a buffer (no copy when possible)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.reshape(-1).view(torch.uint8).numpy()


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Mapping[str, str] | None = None) -> int:
    """Write ``tensors`` to ``path``; returns the bytes written. Tensors are
    laid out by descending element size, so every tensor starts at a
    multiple of its element size; the header is padded to 8 bytes."""
    for k, t in tensors.items():
        if t.dtype not in NAMES:
            raise ValueError(f"save_file: {k} has unsupported dtype {t.dtype}")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header, off = {}, 0
    for k in order:
        t = tensors[k]
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + nbytes]}
        off += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for k in order:
            if tensors[k].numel():
                f.write(_raw_bytes(tensors[k]))
    return 8 + len(hb) + off


def shard_files(ckpt_dir: str) -> list[str]:
    """The safetensors files of a directory: those the index names, in
    order, or every ``*.safetensors`` there, sorted."""
    index = os.path.join(ckpt_dir, INDEX_NAME)
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        names = sorted(set(weight_map.values()))
        return [os.path.join(ckpt_dir, n) for n in names]
    files = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors shards under {ckpt_dir}")
    return files


class ShardedDir(Mapping):
    """The tensors of a directory of shards as one lazy mapping
    name -> tensor (each ``[]`` reads that tensor from its file's mmap)."""

    def __init__(self, ckpt_dir: str):
        self.files = [SafeFile(p) for p in shard_files(ckpt_dir)]
        self.index = {}
        for sf in self.files:
            for k in sf.keys():
                if k in self.index:
                    raise ValueError(f"{k} is in {self.index[k].path} and {sf.path}")
                self.index[k] = sf

    def __getitem__(self, k):
        return self.index[k].get(k)

    def __iter__(self):
        return iter(self.index)

    def __len__(self):
        return len(self.index)

    def __contains__(self, k):
        return k in self.index


def save_sharded(tensors: Mapping[str, torch.Tensor], out_dir: str,
                 prefix: str = "model", max_shard_bytes: int = 4 << 30) -> int:
    """Write ``tensors`` into ``out_dir`` as ``{prefix}-0000i-of-0000n``
    shards of at most ``max_shard_bytes`` (a larger tensor gets a shard of
    its own), in key order, with ``model.safetensors.index.json``; returns
    the bytes written."""
    os.makedirs(out_dir, exist_ok=True)
    groups, cur, size = [], [], 0
    for k in sorted(tensors):
        nb = tensors[k].numel() * tensors[k].element_size()
        if cur and size + nb > max_shard_bytes:
            groups.append(cur)
            cur, size = [], 0
        cur.append(k)
        size += nb
    if cur or not groups:
        groups.append(cur)
    weight_map, total = {}, 0
    for i, keys in enumerate(groups):
        name = f"{prefix}-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        total += save_file({k: tensors[k] for k in keys}, os.path.join(out_dir, name))
        weight_map.update({k: name for k in keys})
    with open(os.path.join(out_dir, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total
