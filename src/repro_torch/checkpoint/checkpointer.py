"""Crash-safe snapshots of a LIVE serving engine (device + host state).

The port's copy of the reference's ``ServeCheckpointer``
(``repro/checkpoint/checkpointer.py``), with its on-disk contract:

  * **Raw bytes + a per-leaf CRC32 manifest**: every device leaf is stored
    as its little-endian bytes at a recorded offset of ``arrays.bin``, with
    key/shape/dtype/offset/nbytes/CRC in ``meta.json``. A bit flip anywhere
    in a leaf is detected at load time (``KVCorruption``), so recovery can
    quarantine the snapshot and fall back. bf16 leaves are stored as their
    2-byte pattern under the dtype name ``"bfloat16"``, so they round-trip
    bit-exactly with numpy alone.
  * **Host state rides along**: the engines' host mirrors (trie index,
    refcounts, allocator free list, ticket table, fault-RNG stream) are a
    JSON blob in the same ``meta.json``, covered by its own CRC.
  * **Blocking save**: fsync on ``arrays.bin``, ``meta.json`` and the
    directory, then an atomic rename; a snapshot is a consistency point
    for the journal.

The device state is the engines' ``ForestState``: a dataclass whose
``cache`` holds the forest, trie or paged store (dataclasses of tensors,
a paged family's ``store`` one level down). The leaves are its tensors,
keyed by their dotted path (``cache.store.k_pages``), and its sampling
``generator``, saved as ``generator.get_state()`` and restored with
``set_state`` — the counterpart of the reference's PRNG key: without it a
sampled replay would draw different noise. Dicts (keys sorted) and
lists/tuples are walked too; every other value (an int, a layout string)
comes from the template. Loaded leaves go to the device of the template's
leaf, so a snapshot restores onto the device the engine runs on.

Snapshots live at ``<dir>/serve_<round:09d>/``; one that fails validation
is renamed to ``serve_<round>.corrupt`` (quarantined, kept for forensics).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import KVCorruption


def _flatten(tree, prefix: str = ""):
    """[(key, leaf)] of every tensor and generator in ``tree``, in a fixed
    order: dataclass fields in declaration order, dict keys sorted,
    sequences by index."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return [(prefix or "leaf", tree)]
    sep = "." if prefix else ""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return []
    out = []
    for name, value in items:
        out.extend(_flatten(value, f"{prefix}{sep}{name}"))
    return out


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree`` with every leaf replaced by ``leaves[key]`` (the inverse of
    ``_flatten`` over the template's structure)."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return leaves[prefix or "leaf"]
    sep = "." if prefix else ""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaves,
                               f"{prefix}{sep}{f.name}")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{sep}{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}{sep}{i}")
                          for i, v in enumerate(tree))
    return tree


def _leaf_to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array of the leaf's raw bytes, saved dtype name)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy(), "uint8"
    t = leaf.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _fill_leaf(tmpl, arr: np.ndarray, dtype_name: str):
    """Copy the saved bytes into ``tmpl`` in place (on its device), so a
    load allocates no second copy of the state."""
    if isinstance(tmpl, torch.Generator):
        tmpl.set_state(torch.from_numpy(arr.copy()))
        return tmpl
    if dtype_name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return tmpl.copy_(t)


def _leaf_shape(leaf) -> tuple:
    if isinstance(leaf, torch.Generator):
        return tuple(leaf.get_state().shape)
    return tuple(leaf.shape)


def _saved_np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16 if name == "bfloat16" else name)


class ServeCheckpointer:
    """Crash-safe snapshots of a live serving engine (device + host state):
    raw leaf bytes with a per-leaf CRC manifest, the host blob with its own
    CRC, a blocking fsync'd atomic save, newest-first load with quarantine
    and fall-back, and ``keep_last_k`` garbage collection."""

    def __init__(self, directory: str, keep_last_k: int = 3):
        self.directory = directory
        self.keep_last_k = keep_last_k
        os.makedirs(directory, exist_ok=True)

    # ---- save ----
    def save(self, round_: int, device_state: Any, host_state: dict) -> str:
        leaves = _flatten(device_state)
        tmp = os.path.join(self.directory, f"tmp.{round_}")
        final = os.path.join(self.directory, f"serve_{round_:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = []
        offset = 0
        with open(os.path.join(tmp, "arrays.bin"), "wb") as f:
            for key, leaf in leaves:
                arr, dtype_name = _leaf_to_numpy(leaf)
                buf = np.ascontiguousarray(arr).tobytes()
                manifest.append({
                    "key": key, "shape": list(arr.shape),
                    "dtype": dtype_name, "offset": offset,
                    "nbytes": len(buf), "crc32": zlib.crc32(buf),
                })
                f.write(buf)
                offset += len(buf)
            f.flush()
            os.fsync(f.fileno())
        host_payload = json.dumps(host_state, separators=(",", ":"))
        meta = {
            "round": round_,
            "manifest": manifest,
            "host": host_payload,
            "host_crc32": zlib.crc32(host_payload.encode()),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):  # idempotent re-save of a round
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        dirfd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._gc()
        return final

    def _gc(self):
        for r in self.all_rounds()[: -self.keep_last_k]:
            shutil.rmtree(os.path.join(self.directory, f"serve_{r:09d}"),
                          ignore_errors=True)

    # ---- load ----
    def all_rounds(self) -> List[int]:
        rounds = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"serve_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, "meta.json")):
                rounds.append(int(m.group(1)))
        return sorted(rounds)

    def path_for(self, round_: int) -> str:
        return os.path.join(self.directory, f"serve_{round_:09d}")

    def load(self, round_: int, template: Any) -> Tuple[Any, dict]:
        """Load one snapshot into ``template``'s tensors and generators (in
        place), verifying every leaf's CRC and the host blob's CRC first.
        Raises ``KVCorruption`` on any mismatch, shape/key drift, or short
        file — then no leaf has been written and the caller decides
        whether to fall back."""
        path = self.path_for(round_)
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise KVCorruption(f"snapshot {path}: unreadable meta ({e})")
        if zlib.crc32(meta["host"].encode()) != meta["host_crc32"]:
            raise KVCorruption(f"snapshot {path}: host-state CRC mismatch")
        host_state = json.loads(meta["host"])
        with open(os.path.join(path, "arrays.bin"), "rb") as f:
            blob = f.read()
        leaves = _flatten(template)
        by_key = {ent["key"]: ent for ent in meta["manifest"]}
        if [e["key"] for e in meta["manifest"]] != [k for k, _ in leaves]:
            raise KVCorruption(
                f"snapshot {path}: leaf keys do not match template "
                f"(snapshot from an incompatible engine config?)")
        checked = []
        for key, tmpl in leaves:
            ent = by_key[key]
            buf = blob[ent["offset"]: ent["offset"] + ent["nbytes"]]
            if len(buf) != ent["nbytes"]:
                raise KVCorruption(
                    f"snapshot {path}: leaf {key} truncated "
                    f"({len(buf)}/{ent['nbytes']} bytes)")
            if zlib.crc32(buf) != ent["crc32"]:
                raise KVCorruption(
                    f"snapshot {path}: leaf {key} CRC mismatch — "
                    f"bytes on disk changed after save")
            arr = np.frombuffer(buf, dtype=_saved_np_dtype(ent["dtype"]))
            arr = arr.reshape(ent["shape"])
            if tuple(arr.shape) != _leaf_shape(tmpl):
                raise KVCorruption(
                    f"snapshot {path}: leaf {key} shape {arr.shape} vs "
                    f"template {_leaf_shape(tmpl)}")
            checked.append((key, tmpl, arr, ent["dtype"]))
        out = {key: _fill_leaf(tmpl, arr, dtype)
               for key, tmpl, arr, dtype in checked}
        return _unflatten(template, out), host_state

    def quarantine(self, round_: int):
        """Rename a failed snapshot out of the ``serve_*`` namespace so it
        is never considered again (kept on disk for forensics)."""
        path = self.path_for(round_)
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            shutil.rmtree(path, ignore_errors=True)

    def load_latest(
        self, template: Any,
        validate: Optional[Callable[[int, Any, dict], None]] = None,
    ) -> Tuple[int, Any, dict]:
        """Newest-first load with fall-back: snapshots failing CRC checks
        or the caller's ``validate`` hook (e.g. engine segment-checksum
        verification) are quarantined and the next-older one is tried.
        Returns ``(round, device_state, host_state)``; raises
        ``FileNotFoundError`` when no valid snapshot remains."""
        errors = []
        for r in reversed(self.all_rounds()):
            try:
                device_state, host_state = self.load(r, template)
                if validate is not None:
                    validate(r, device_state, host_state)
                return r, device_state, host_state
            except KVCorruption as e:
                errors.append(str(e))
                self.quarantine(r)
        raise FileNotFoundError(
            f"no valid serve snapshot in {self.directory}"
            + (f" (rejected: {errors})" if errors else ""))


__all__ = ["ServeCheckpointer"]
