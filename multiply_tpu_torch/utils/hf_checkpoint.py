"""Reading a local `from_pretrained` directory without `transformers` or `safetensors`.

A Hugging Face model directory holds `config.json` (the model's settings),
its weights as `model.safetensors` (or shards listed in
`model.safetensors.index.json`) or as a pickled `pytorch_model.bin`, and for
an image model often `preprocessor_config.json`. The safetensors format is
parsed here by hand: 8 bytes of little-endian header length, a JSON header
mapping each tensor's name to its dtype, shape and byte range, then the raw
little-endian tensors. A `.bin` is read with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import json
import os
import struct

import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def read_config(directory: str) -> dict:
    """The directory's `config.json` as a dict."""
    return read_json(os.path.join(directory, "config.json"))


def read_preprocessor_config(directory: str) -> dict | None:
    """The directory's `preprocessor_config.json`, or None where there is none."""
    path = os.path.join(directory, "preprocessor_config.json")
    return read_json(path) if os.path.exists(path) else None


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file, on the CPU, in its stored dtype."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}, which is not read")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * dtype.itemsize or base + end > len(data):
            raise ValueError(f"{path}: tensor {name} has {end - begin} bytes for shape {shape} of {meta['dtype']}")
        buf = bytearray(data[base + begin:base + end])
        t = torch.frombuffer(buf, dtype=dtype, count=count) if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def read_state_dict(directory: str) -> dict[str, torch.Tensor]:
    """The weights of a `from_pretrained` directory: `model.safetensors`, the
    shards of `model.safetensors.index.json`, or `pytorch_model.bin`."""
    single = os.path.join(directory, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    index = os.path.join(directory, "model.safetensors.index.json")
    if os.path.exists(index):
        out = {}
        for shard in sorted(set(read_json(index)["weight_map"].values())):
            out.update(read_safetensors(os.path.join(directory, shard)))
        return out
    binary = os.path.join(directory, "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{directory}: no model.safetensors, model.safetensors.index.json or pytorch_model.bin")
