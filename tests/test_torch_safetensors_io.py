"""The port's safetensors reader and writer (``utils/safetensors_io.py``):
round trips in every dtype, files read and written by the ``safetensors``
package, sharded directories with and without an index."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from mxmoe_tpu_torch.utils import safetensors_io as st

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8, torch.int32,
          torch.int64]


def _tensor(dtype, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -(1 << 30)), min(info.max, 1 << 30)
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_round_trip_every_dtype(tmp_path, dtype):
    tensors = {"a": _tensor(dtype, (3, 5)), "b.c": _tensor(dtype, (7,), 1),
               "scalar": _tensor(dtype, (), 2), "empty": _tensor(dtype, (0, 4), 3),
               "other": _tensor(torch.int8, (5,), 4)}
    path = str(tmp_path / "x.safetensors")
    nbytes = st.save_file(tensors, path, {"format": "pt"})
    assert nbytes == os.path.getsize(path)
    f = st.open_file(path)
    assert sorted(f.keys()) == sorted(tensors)
    assert f.metadata() == {"format": "pt"}
    for k, t in tensors.items():
        assert f.dtype(k) == t.dtype and f.shape(k) == tuple(t.shape)
        got = f.get(k)
        assert got.dtype == t.dtype and got.shape == t.shape
        # compared as bytes: bit for bit, NaN payloads included
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           t.reshape(-1).view(torch.uint8)), k
    # every tensor starts on a multiple of its element size
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    assert n % 8 == 0
    for k, t in tensors.items():
        assert (8 + n + header[k]["data_offsets"][0]) % t.element_size() == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cross_read_with_the_safetensors_package(tmp_path, dtype):
    sft = pytest.importorskip("safetensors.torch")
    tensors = {"w": _tensor(dtype, (4, 6)), "v": _tensor(dtype, (9,), 1),
               "h": _tensor(torch.bfloat16, (2, 3), 2)}
    ours = str(tmp_path / "ours.safetensors")
    st.save_file(tensors, ours)
    theirs_read = sft.load_file(ours)
    theirs = str(tmp_path / "theirs.safetensors")
    sft.save_file(tensors, theirs, metadata={"k": "v"})
    f = st.open_file(theirs)
    assert f.metadata() == {"k": "v"}
    for k, t in tensors.items():
        assert torch.equal(theirs_read[k], t), k
        assert torch.equal(f.get(k), t), k


def test_unaligned_tensor_is_read_through_a_copy(tmp_path):
    """A writer that packs tensors without alignment: an f32 tensor after 3
    int8 bytes."""
    a = torch.tensor([1, -2, 3], dtype=torch.int8)
    b = torch.tensor([1.5, -2.25], dtype=torch.float32)
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [3, 11]}}
    hb = json.dumps(header).encode()
    path = tmp_path / "odd.safetensors"
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(hb)) + hb + a.numpy().tobytes()
                 + b.numpy().tobytes())
    f = st.open_file(str(path))
    assert torch.equal(f.get("a"), a) and torch.equal(f.get("b"), b)


def test_sharded_directory_with_and_without_index(tmp_path):
    tensors = {f"t{i}": _tensor(torch.float32, (64, 16), i) for i in range(6)}
    tensors["q"] = _tensor(torch.int8, (200,), 9)
    out = str(tmp_path / "sharded")
    st.save_sharded(tensors, out, prefix="params", max_shard_bytes=3 * 64 * 16 * 4)
    files = st.shard_files(out)
    assert len(files) == 3
    with open(os.path.join(out, st.INDEX_NAME)) as fh:
        weight_map = json.load(fh)["weight_map"]
    assert sorted(weight_map) == sorted(tensors)
    sd = st.ShardedDir(out)
    assert sorted(sd) == sorted(tensors) and len(sd) == len(tensors)
    for k, t in tensors.items():
        assert torch.equal(sd[k], t)
        assert os.path.basename(sd.index[k].path) == weight_map[k]
    # without the index: every *.safetensors, sorted
    os.remove(os.path.join(out, st.INDEX_NAME))
    sd2 = st.ShardedDir(out)
    assert all(torch.equal(sd2[k], t) for k, t in tensors.items())
    # a name in two shards is refused
    st.save_file({"t0": tensors["t0"]}, os.path.join(out, "zz.safetensors"))
    with pytest.raises(ValueError, match="t0"):
        st.ShardedDir(out)
    with pytest.raises(FileNotFoundError):
        st.ShardedDir(str(tmp_path))


def test_reader_returns_writable_tensors_that_leave_the_file_alone(tmp_path):
    path = str(tmp_path / "w.safetensors")
    st.save_file({"x": torch.zeros(4)}, path)
    t = st.open_file(path).get("x")
    t += 1.0
    assert torch.equal(st.open_file(path).get("x"), torch.zeros(4))
    assert np.all(t.numpy() == 1.0)
