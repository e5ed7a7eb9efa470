"""Checkpointing: atomic, integrity-checked, async, keep-last-k, resumable;
the port of ``repro.checkpoint.manager``, on the same on-disk layout::

    <dir>/step_000000123.tmp-<pid>-<nonce>/   (written, fsynced)
        arrays.npz                   (flattened tree, path-keyed)
        manifest.json                (step, tree paths, shapes, sha256)
    <dir>/step_000000123/            (atomic rename: the commit)

Keys are the leaves' paths as :func:`repro_torch.tree.keystr` prints them,
which is how ``jax.tree_util.keystr`` prints the same tree, and bfloat16
leaves are stored as float32 (restore casts back to the target leaf's
type), as the reference stores them.  So a checkpoint that either package
writes restores into the other: parameters, ``m``, ``v``, ``err`` and
``count`` of a training state.

Restore picks the newest committed step whose manifest hash verifies; a
half-written or corrupt step is skipped, never loaded.  It writes into the
given tree's tensors in place, after the hash has verified, so restoring
a state needs no second copy of it on the device.  The npz's members are
stored, not compressed, so restore maps each array straight from the file
(no zip CRC pass, no copy on the host): the hash reads the file once and
the load reads it again from the page cache.

The arrays go to disk one at a time, each hashed while it is written (the
hash runs on a second thread), so a save holds one leaf in float32 on the
host, never the whole state.  ``save_async`` first copies the tree to the
host (the training loop changes its tensors in place), then writes from a
background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import struct
import threading
import time
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


def _leaves(tree_) -> Dict[str, Any]:
    return {tree.keystr(path): leaf
            for path, leaf in tree.flatten_with_path(tree_)}


def _as_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as the array the format stores: bfloat16, which numpy lacks,
    upcast to float32."""
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _sha(arrays) -> str:
    """sha256 over the keys in sorted order and each array's bytes, as the
    reference hashes them; ``arrays`` maps a key to an array or to a
    function returning it."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = arrays[k]
        h.update(k.encode())
        h.update(np.ascontiguousarray(a() if callable(a) else a))
    return h.hexdigest()


def _write_npz(path: str, leaves: Dict[str, Any]) -> Tuple[str, Dict]:
    """Write ``leaves`` as an npz (``np.savez``'s layout: one ``<key>.npy``
    member a key, stored) one array at a time in sorted key order, hashed
    on a second thread as it goes.  Returns (sha256, shapes)."""
    h = hashlib.sha256()
    todo: "queue.Queue" = queue.Queue(maxsize=2)

    def hasher():
        while (item := todo.get()) is not None:
            key, arr = item
            h.update(key.encode())
            h.update(arr)

    worker = threading.Thread(target=hasher, daemon=True)
    worker.start()
    shapes = {}
    try:
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key in sorted(leaves):
                arr = _as_numpy(leaves[key])
                if not arr.flags.c_contiguous:
                    arr = np.ascontiguousarray(arr)
                shapes[key] = list(arr.shape)
                todo.put((key, arr))
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                del arr
    finally:
        todo.put(None)
        worker.join()
    return h.hexdigest(), shapes


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an npz whose members are stored (``np.savez``'s
    layout, as both packages write it), each mapped from the file
    read-only; a compressed member is read through ``np.load``."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename[:-4] if info.filename.endswith(".npy") \
                else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                with np.load(path) as z:
                    out[key] = z[key]
                continue
            f.seek(info.header_offset)
            local = f.read(30)              # the member's local header
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if dtype.hasobject:
                raise IOError(f"{key}: object arrays are not stored")
            n = int(np.prod(shape)) if shape else 1
            if n == 0:
                out[key] = np.empty(shape, dtype)
                continue
            out[key] = np.memmap(path, dtype=dtype, mode="r", shape=shape,
                                 offset=f.tell(),
                                 order="F" if fortran else "C")
    return out


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True                  # exists, owned by someone else
    except OSError:
        return False
    return True


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree_) -> str:
        self.wait()                      # never two writers at once
        return self._commit(step, _leaves(tree_))

    def save_async(self, step: int, tree_) -> None:
        self.wait()                      # one in flight at a time
        # copy to the host on the caller's thread: the caller goes on
        # changing the tensors in place
        snap = {k: v.detach().to("cpu", copy=True)
                for k, v in _leaves(tree_).items()}

        def run():
            try:
                self._commit(step, snap)
            except Exception as e:       # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _commit(self, step: int, leaves: Dict[str, Any]) -> str:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + f".tmp-{os.getpid()}-{time.time_ns()}"
        os.makedirs(tmp, exist_ok=True)
        sha, shapes = _write_npz(os.path.join(tmp, "arrays.npz"), leaves)
        manifest = {"step": step, "sha256": sha, "keys": sorted(shapes),
                    "shapes": shapes}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
        # drop orphaned tmp dirs of crashed writers: the name embeds the
        # writer's pid (".tmp-<pid>-<nonce>"); a dead pid can never commit
        for name in os.listdir(self.dir):
            if ".tmp-" not in name:
                continue
            try:
                pid = int(name.split(".tmp-", 1)[1].split("-", 1)[0])
            except (IndexError, ValueError):
                pid = -1
            if pid == os.getpid() or _pid_alive(pid):
                continue
            shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like_tree, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into ``like_tree``: each leaf's tensor is overwritten in
        place (cast to its type, on its device) and the tree returned, with
        the step.  Verifies the manifest hash first; falls back to older
        steps on corruption."""
        candidates = self.all_steps() if step is None else [step]
        for s in reversed(candidates):
            path = os.path.join(self.dir, f"step_{s:09d}")
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    manifest = json.load(f)
                arrays = _read_npz(os.path.join(path, "arrays.npz"))
                if _sha(arrays) != manifest["sha256"]:
                    raise IOError("hash mismatch")
                self._load(arrays, manifest["shapes"], like_tree)
            except Exception:
                continue
            return like_tree, s
        raise FileNotFoundError(f"no valid checkpoint in {self.dir}")

    @staticmethod
    @torch.no_grad()
    def _load(arrays, shapes: Dict[str, List[int]], like_tree) -> None:
        """Every leaf is checked against the manifest before any is
        written; each array goes to its leaf's device as stored and is cast
        there."""
        leaves = _leaves(like_tree)
        wrong = [k for k, like in leaves.items()
                 if k not in arrays or list(like.shape) != shapes.get(k)
                 or list(arrays[k].shape) != shapes.get(k)]
        if wrong:
            raise KeyError(f"checkpoint lacks or mis-shapes {wrong[:3]}")
        for key, like in leaves.items():
            with warnings.catch_warnings():
                # read-only maps: the tensor is only ever read
                warnings.simplefilter("ignore", UserWarning)
                src = torch.from_numpy(np.asarray(arrays[key]))
            like.copy_(src.to(like.device))
