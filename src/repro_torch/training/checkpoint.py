"""Training checkpoints, port of ``repro.training.checkpoint`` (the model's
weights and the optimizer state; ``core/runtime/checkpoint.py`` saves
mining state).

The reference's layout per step:
    <dir>/step_<N>.tmp/            (written, then renamed)
        manifest.json              leaf names, shapes and dtypes
        shard_0.npz                one array per leaf; bf16 as its uint16 bits
    <dir>/step_<N>/                atomic rename commit

A tree is nested dicts and NamedTuples (the optimizer state) of tensors.
Its leaves are keyed by name, the keys joined by "." (``params.<parameter
name>``, ``opt.step``, ``opt.master.<parameter name>``, ...), where the
reference keys them by position in a JAX treedef. Restart contract:
``latest_step``/``restore`` never see a torn checkpoint (atomic rename).
``restore`` puts each array on the device and in the dtype of the matching
leaf of a like-tree, so a checkpoint written on the card restores onto the
CPU, or into f32, and back (the one-card analogue of the reference's
elastic resharding).

The npz is a standard one (``np.load`` reads it), written and read a leaf
at a time in single large I/O calls: a leaf's .npy header, then its bytes
in one write (``np.savez`` copies them in 16 MB pieces), and on restore
each member's bytes read in one ``np.fromfile`` at their offset in the
uncompressed archive (``np.load`` reads 256 KB pieces through ``zipfile``
and checks each member's CRC; this reader does not). A full-width
checkpoint is tens of GB (stablelm-1.6b's: 23 GB).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "", out=None) -> Dict[str, torch.Tensor]:
    """The tree's leaves by their dotted names, in the tree's order."""
    out = {} if out is None else out
    if _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, Mapping):
        items = tree.items()
    else:
        out[prefix[:-1]] = tree
        return out
    for key, val in items:
        flatten(val, f"{prefix}{key}.", out)
    return out


def _unflatten(like, flat: Mapping[str, Any], prefix: str = ""):
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, flat, f"{prefix}{k}.")
                            for k, v in zip(like._fields, like)))
    if isinstance(like, Mapping):
        return {k: _unflatten(v, flat, f"{prefix}{k}.")
                for k, v in like.items()}
    return flat[prefix[:-1]]


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        # npz has no bf16: store the raw uint16 view, dtype in the manifest
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t) -> str:
    return str(torch.as_tensor(t).dtype).replace("torch.", "")


def save(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves = flatten(tree)
    manifest = {
        "step": step,
        "leaves": [{"name": name, "shape": list(t.shape),
                    "dtype": _dtype_name(t)} for name, t in leaves.items()],
    }
    with zipfile.ZipFile(os.path.join(tmp, "shard_0.npz"), "w",
                         zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, t in leaves.items():
            arr = np.ascontiguousarray(_to_numpy(t))
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(memoryview(arr.reshape(-1)).cast("B"))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _steps(directory: str):
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def _read_npz(path: str, names):
    """Yields ``(name, array)`` for each of ``names``, in order, from the
    uncompressed npz at ``path``, each read in one call at its member's
    offset."""
    with zipfile.ZipFile(path) as zf:
        infos = {i.filename[:-4]: i for i in zf.infolist()}
    with open(path, "rb") as f:
        for name in names:
            info = infos[name]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: member {name} is compressed")
            f.seek(info.header_offset)
            head = f.read(30)              # the local file header
            f.seek(info.header_offset + 30
                   + int.from_bytes(head[26:28], "little")
                   + int.from_bytes(head[28:30], "little"))
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if fortran:
                raise ValueError(f"{path}: member {name} is Fortran-ordered")
            count = int(np.prod(shape, dtype=np.int64))
            yield name, np.fromfile(f, dtype=dtype, count=count).reshape(
                shape)


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def restore(directory: str, step: int, like_tree):
    """Load into the structure of ``like_tree``: each leaf on the device and
    in the dtype of the like-tree's leaf of the same name."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    like = flatten(like_tree)
    missing = [name for name in like if name not in dtypes]
    if missing:
        raise KeyError(f"checkpoint step {step} in {directory} has no leaf "
                       f"{missing[0]!r}")
    loaded = {}
    for name, arr in _read_npz(os.path.join(path, "shard_0.npz"), like):
        ref = like[name]
        if dtypes[name] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        loaded[name] = t.to(device=ref.device, dtype=ref.dtype)
        del arr, t
    return _unflatten(like_tree, loaded)


def retain(directory: str, keep: int = 3):
    """Garbage-collect old checkpoints, keeping the newest ``keep``."""
    if not os.path.isdir(directory):
        return
    for s in sorted(_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
