"""Orbax checkpoints of the JAX package, read without jax, orbax,
tensorstore or zstandard.

The JAX trainer writes each checkpoint with ``ocp.StandardCheckpointer``
(``patch_toon_tpu/train/checkpoints.py``): a directory holding

- ``_METADATA``: JSON whose ``tree_metadata`` lists every leaf by its key
  path (``key_type`` 2 a dict key, 1 a sequence index) and value type;
  ``None`` leaves are marked ``skip_deserialize`` (the optax chain's empty
  states) and are kept as ``None``, empty containers (``Tuple``, ``List``,
  ``Dict``: ``optax.MultiSteps``' ``skip_state``) as empty ones;
- an OCDBT database (``utils/ocdbt.py``) whose keys are zarr v2 arrays,
  one per leaf, named by the key path joined with ".": ``<name>/.zarray``
  (dtype, shape, chunks, compressor, fill_value, order) and a key per
  chunk (``0.0.0.0``; ``0`` for a scalar), each chunk a zstd frame
  (``native/zstd.py``);
- ``meta.json``, the trainer's sidecar (``input_channels``, the generator
  and discriminator args, the epoch and score).

:func:`read_tree` gives the tree as nested dicts and lists of numpy arrays,
each a copy that owns its memory. :func:`restore_generator`,
:func:`sniff_input_channels` and :func:`read_meta` are the counterparts of
the JAX package's functions of those names. Nothing here waits for another
process: every process (each card of the engine, each ``file_shard``
process) reads the directory on its own, as JAX's ``_local_checkpointer``
lets it.
"""

from __future__ import annotations

import itertools
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from patch_toon_tpu_torch.native import zstd
from patch_toon_tpu_torch.utils.ocdbt import Database, OcdbtError

DTYPES = ("<f2", "<f4", "<f8", "<i1", "<i2", "<i4", "<i8", "|i1", "|u1",
          "<u1", "<u2", "<u4", "<u8", "|b1", "bool")


_EMPTY = {"Tuple": tuple, "List": list, "Dict": dict}


class OrbaxError(ValueError):
    """A checkpoint directory the reader refuses or finds damaged."""


@dataclass
class ReadStats:
    """What a read moved: chunks, their compressed and decoded bytes and
    the seconds spent in the zstd decoder."""
    chunks: int = 0
    compressed_bytes: int = 0
    decoded_bytes: int = 0
    decode_s: float = 0.0


def read_meta(path) -> Dict[str, Any]:
    """``meta.json`` of a checkpoint directory; {} without one (JAX
    ``CheckpointManager.read_meta``)."""
    f = Path(path) / "meta.json"
    if f.exists():
        with open(f) as fh:
            return json.load(fh)
    return {}


def _metadata(path: Path) -> Dict[Tuple[Any, ...], Dict[str, Any]]:
    """{key path: value metadata}, each key a str (dict key) or int
    (sequence index)."""
    f = path / "_METADATA"
    try:
        with open(f) as fh:
            meta = json.load(fh)
    except OSError as e:
        raise OrbaxError(f"{path} is not an Orbax checkpoint: {f} cannot "
                         f"be read ({e})") from e
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{path} stores zarr v3 arrays; the reader takes "
                         "zarr v2")
    if meta.get("use_ocdbt") is False:
        raise OrbaxError(f"{path} does not use OCDBT; the reader takes "
                         "OCDBT checkpoints")
    out = {}
    for entry in meta["tree_metadata"].values():
        keys = tuple(int(k["key"]) if k["key_type"] == 1 else k["key"]
                     for k in entry["key_metadata"])
        out[keys] = entry["value_metadata"]
    return out


def _zarray(db: Database, name: str,
            items: Optional[Dict[bytes, Any]] = None) -> Dict[str, Any]:
    key = f"{name}/.zarray"
    if items is None:
        raw = db.read(key)
    else:
        raw = db.value(items[key.encode()]) if key.encode() in items else None
    if raw is None:
        raise OrbaxError(f"{db.directory}: array {name} has no .zarray")
    z = json.loads(raw)
    if z.get("zarr_format") != 2:
        raise OrbaxError(f"{name}: zarr format {z.get('zarr_format')}; the "
                         "reader takes 2")
    if z.get("filters"):
        raise OrbaxError(f"{name}: zarr filters {z['filters']} are not read")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxError(f"{name}: compressor {comp.get('id')!r}; the "
                         "reader takes zstd and none")
    if z["dtype"] not in DTYPES:
        raise OrbaxError(f"{name}: dtype {z['dtype']!r} is not read (it "
                         f"takes {', '.join(DTYPES)})")
    if z.get("order", "C") not in ("C", "F"):
        raise OrbaxError(f"{name}: order {z['order']!r}")
    return z


def _fill(z: Dict[str, Any], dtype: np.dtype):
    fv = z.get("fill_value")
    if fv is None:
        return 0
    if isinstance(fv, str):  # "NaN", "Infinity", "-Infinity"
        return float(fv.replace("Infinity", "inf"))
    return np.array(fv).astype(dtype)


def _read_array(db: Database, name: str, items: Dict[bytes, Any],
                stats: ReadStats) -> np.ndarray:
    z = _zarray(db, name, items)
    dtype = np.dtype("bool" if z["dtype"] in ("|b1", "bool") else z["dtype"])
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    fortran = z.get("order", "C") == "F"
    out = np.full(shape, _fill(z, dtype), dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in itertools.product(*grid) if shape else [()]:
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        if key not in items:
            continue  # a chunk equal to the fill value
        data = db.value(items[key])
        buf = np.empty(chunk_bytes, np.uint8)
        t0 = time.perf_counter()
        if z.get("compressor") is None:
            if len(data) != chunk_bytes:
                raise OrbaxError(f"{name}: chunk {key.decode()} holds "
                                 f"{len(data)} bytes, {chunk_bytes} expected")
            buf[:] = np.frombuffer(data, np.uint8)
        else:
            got = zstd.decompress_into(data, buf, f"{name} chunk "
                                       f"{key.decode()}")
            if got != chunk_bytes:
                raise OrbaxError(f"{name}: chunk {key.decode()} decodes to "
                                 f"{got} bytes, {chunk_bytes} expected")
        stats.decode_s += time.perf_counter() - t0
        stats.chunks += 1
        stats.compressed_bytes += len(data)
        stats.decoded_bytes += chunk_bytes
        chunk = buf.view(dtype).reshape(chunks, order="F" if fortran else "C")
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _open(path: Path) -> Database:
    try:
        return Database(path)
    except OcdbtError as e:
        raise OrbaxError(f"{path}: {e}") from e


def _nest(leaves: Dict[Tuple[Any, ...], Any]) -> Dict[str, Any]:
    """Nested dicts (str keys) and lists (int keys) from flat key paths."""
    root: Dict[Any, Any] = {}
    for keys, value in leaves.items():
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in range(max(node) + 1)]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def read_tree(path, select: Optional[Iterable[str]] = None,
              stats: Optional[ReadStats] = None) -> Dict[str, Any]:
    """The checkpoint's tree: nested dicts and lists of numpy arrays, and
    None for the leaves Orbax skips. ``select`` keeps only the top-level
    entries it names (``g_params``, ...)."""
    stats = stats if stats is not None else ReadStats()
    path = Path(path)
    meta = _metadata(path)
    keep = None if select is None else set(select)
    want = {k: v for k, v in meta.items()
            if keep is None or k[0] in keep}
    db = _open(path)
    try:
        items = dict(db.items())
        leaves: Dict[Tuple[Any, ...], Any] = {}
        for keys, vm in want.items():
            if vm.get("skip_deserialize") or vm.get("value_type") == "None":
                # None, or an empty container (optax.MultiSteps' skip_state)
                leaves[keys] = _EMPTY.get(vm.get("value_type"), lambda: None)()
                continue
            name = ".".join(map(str, keys))
            leaves[keys] = _read_array(db, name, items, stats)
    except (OcdbtError, zstd.ZstdError) as e:
        raise OrbaxError(f"{path}: {e}") from e
    return _nest(leaves)


def restore_generator(path, stats: Optional[ReadStats] = None
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The generator's (params, batch_stats) of a checkpoint (JAX
    ``restore_generator``); batch_stats is {} when it has none."""
    tree = read_tree(path, ("g_params", "g_batch_stats"), stats)
    if "g_params" not in tree:
        raise OrbaxError(f"{path} holds no g_params")
    return tree["g_params"], tree.get("g_batch_stats", {})


def sniff_input_channels(path) -> Optional[int]:
    """The generator's input channels: ``meta.json``'s ``input_channels``,
    else the first conv kernel's shape from its ``.zarray`` alone (HWIO,
    so index 2), as JAX's metadata read does."""
    meta = read_meta(path)
    if "input_channels" in meta:
        return int(meta["input_channels"])
    if not (Path(path) / "_METADATA").is_file():
        raise OrbaxError(f"{path} is not an Orbax checkpoint: it holds no "
                         "_METADATA")
    try:
        z = _zarray(_open(Path(path)), "g_params.initial_conv.conv.kernel")
    except (OcdbtError, zstd.ZstdError) as e:
        raise OrbaxError(f"{path}: {e}") from e
    return int(z["shape"][2])
