"""Atomic tree checkpoint store, in the reference's on-disk layout.

Layout:  <dir>/step_<N>/<name>/
            manifest.json       # leaf paths, files, dtypes, shapes + metadata
            leaf_00000.npy ...  # one .npy per leaf
         <dir>/step_<N>/COMMITTED   # written once every name has landed

Leaves are numbered and named as the reference numbers and names them (JAX's
leaf order and key paths, ``repro_torch.tree``), bfloat16 is stored as its
``uint16`` bits, so either package reads what the other wrote (the port
reads a reference checkpoint through ``bridge.read_repro_checkpoint``).

Atomicity: write into ``<name>.tmp-<pid>`` then ``os.rename``; a step
counts only once its ``COMMITTED`` marker exists, so a crashed writer never
leaves a step that ``list_steps`` would pick up.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.bfloat16: "bfloat16",
              torch.int64: "int64", torch.int32: "int32",
              torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
              torch.bool: "bool"}


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its logical dtype (bfloat16 as its
    ``uint16`` bits); tensors are copied off their device."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _logical_dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NP_DTYPES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def save_pytree(directory: str, step: int, tree, metadata: dict | None = None,
                name: str = "state") -> str:
    """Atomically write ``tree`` under ``directory/step_<step>/<name>``."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    final = os.path.join(step_dir, name)
    tmp = final + f".tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "name": name, "metadata": metadata or {},
                "leaves": []}
    for i, (p, leaf) in enumerate(flatten_with_paths(tree)):
        arr = to_host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": p, "file": fname, "dtype": _logical_dtype(leaf),
             "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def read_manifest(directory: str, step: int, name: str):
    """(the directory of ``name`` at ``step``, its manifest)."""
    final = os.path.join(directory, f"step_{step:08d}", name)
    with open(os.path.join(final, "manifest.json")) as f:
        return final, json.load(f)


def load_leaf(final: str, entry: dict) -> torch.Tensor:
    """One manifest entry's array as a CPU tensor of its logical dtype."""
    arr = np.load(os.path.join(final, entry["file"]))
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_pytree(directory: str, step: int, example_tree,
                   name: str = "state"):
    """Restore into the structure of ``example_tree``.

    ``example_tree``'s leaves are tensors (those on the ``meta`` device
    allocate nothing): their shapes are checked, their dtypes kept, and each
    restored leaf goes to the example's device (a meta example's to the
    CPU)."""
    final, manifest = read_manifest(directory, step, name)
    flat = flatten_with_paths(example_tree)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    paths = [p for p, _ in flat]
    if set(paths) != set(by_path):
        missing = set(paths) - set(by_path)
        extra = set(by_path) - set(paths)
        raise ValueError(
            f"checkpoint tree mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")
    out = []
    for p, ex in flat:
        t = load_leaf(final, by_path[p])
        want = tuple(ex.shape)
        if tuple(t.shape) != want:
            raise ValueError(
                f"{p}: checkpoint shape {tuple(t.shape)} != expected {want}")
        dev = "cpu" if ex.device.type == "meta" else ex.device
        out.append(t.to(device=dev, dtype=ex.dtype))
    return unflatten(example_tree, out)


def load_metadata(directory: str, step: int, name: str = "state") -> dict:
    _, manifest = read_manifest(directory, step, name)
    return manifest.get("metadata", {})


def list_steps(directory: str) -> list[int]:
    """Committed steps, ascending (a step is committed iff marker exists)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            full = os.path.join(directory, d)
            if os.path.isdir(full) and os.path.exists(
                    os.path.join(full, "COMMITTED")):
                steps.append(int(d[len("step_"):]))
    return sorted(steps)


def mark_committed(directory: str, step: int) -> None:
    path = os.path.join(directory, f"step_{step:08d}", "COMMITTED")
    with open(path, "w") as f:
        f.write("ok")


def delete_step(directory: str, step: int) -> None:
    shutil.rmtree(os.path.join(directory, f"step_{step:08d}"),
                  ignore_errors=True)
