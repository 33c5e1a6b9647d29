"""Pytree checkpointing on npz, in the reference's layout (port of
``repro/checkpoint/store.py``).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``.  Leaves are stored
as ``leaf_<i>`` in ``jax.tree.leaves`` order with their keypath names
(``[0]['groups'][0]['attn']['wq']``, ``[1].mu['embed']``), so a
checkpoint written by either package restores in the other; bfloat16
leaves are stored through a uint16 view (npz has no native bf16).  Writes
are atomic (tmp dir + rename) — a killed run never leaves a half-written
checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from .. import tree as T

def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name in meta.json)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A torch copy of ``arr``; a ``"bfloat16"`` array may be stored as
    uint16 bits or carry numpy's bfloat16 extension dtype."""
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    meta = {}
    for i, (path, leaf) in enumerate(T.leaves_with_paths(tree)):
        key = f"leaf_{i}"
        arrays[key], dtype = _to_numpy(leaf)
        meta[key] = {"path": path.replace("/", "_"), "dtype": dtype}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "leaves": meta}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, tree, step: int | None = None,
                       device=None):
    """Restore into the structure of ``tree`` (a template tree).  Each leaf
    lands on ``device``, or on its template leaf's device when the template
    leaf is a tensor and ``device`` is None.  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    template = T.leaves(tree)
    if len(template) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, template has "
            f"{len(template)}")
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, tmpl in enumerate(template):
            key = f"leaf_{i}"
            dev = device if device is not None else (
                tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
            out.append(_from_numpy(data[key], meta["leaves"][key]["dtype"],
                                   dev))
    return T.unflatten(tree, out), step
