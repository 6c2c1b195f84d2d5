"""Tree-structured npz checkpointing with atomic write, integrity
manifest, step tracking, and a retained-last-k store (counterpart of
``repro/checkpoint/ckpt.py``, in the JAX package's file format).

The format is the JAX package's, so a checkpoint written by either
package loads in the other: an npz (an uncompressed zip of ``.npy``
members) whose keys are the tree's ``/``-joined paths, plus ``__step__``
(the step), ``__dtypes__`` (JSON: the true dtype of every leaf stored in
an unsigned bit carrier; bfloat16 leaves go as ``u2``), ``__manifest__``
(JSON: the crc32 of every stored array's bytes but the dtype table's)
and, for a list or tuple, ``<path>/__seq__`` = ``[len, is_tuple]``.

Where the JAX package builds the whole flat tree on the host and hands it
to ``np.savez``, the port writes one leaf at a time into the zip (an npy
header, then the leaf's buffer as it is), so the host holds one leaf,
not the tree, and reads each leaf's bytes once: the manifest's crc comes
out of the zip's own crc of the member.  bfloat16 bits come from torch
(``view(torch.int16)``), never through a numpy bfloat16, which needs
``ml_dtypes``.

On a mesh of ranks (``specs=`` and ``mesh=``: each leaf's
``PartitionSpec`` and the ``parallel.mesh.Mesh``) the file is the same
whole-array file the JAX package writes from its sharded arrays: a save
gathers one leaf at a time onto rank 0 (``sharding.gather_to_first``),
which alone writes it, every rank waiting at the end until the file is
in place; a restore checks the file against the live shards' full
shapes (each rank checking the crc of every R-th leaf, the verdicts
all-gathered) and copies each rank's ``local_shard`` of each leaf into
its shard.  So a file written by any number of ranks loads on any mesh
of the same model, and on one rank.

Reading maps the file into memory and takes each leaf as a view of its
stored bytes.  Restoring into live tensors (``load_checkpoint(path,
into=tree)``) reads the file twice: the first pass checks every leaf, one
at a time, against the manifest and the keys, shapes and dtypes against
``into``; only then does the second pass ``copy_`` each leaf into its
live tensor.  A corrupt file so never half-overwrites the live state,
and the card never holds two states.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import re
import struct
import tempfile
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.parallel.mesh import axis_size
from repro_torch.parallel.sharding import (gather_to_first, local_shard,
                                          mentioned)

_SPECIAL = ("__step__", "__dtypes__", "__manifest__")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed integrity verification (truncated,
    unreadable, or with leaves whose bytes no longer match the manifest
    recorded at save time)."""


def _flatten(tree, prefix=""):
    """``(key, leaf)`` pairs in the JAX package's key layout; leaves stay
    as they are (tensors are brought to the host one at a time)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        yield prefix + "__seq__", np.asarray(
            [len(tree), int(isinstance(tree, tuple))])
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def _unflatten(flat: dict):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if "__seq__" in node:
            n, is_tuple = (int(v) for v in node["__seq__"][:2])
            seq = [rebuild(node[str(i)]) for i in range(n)]
            return tuple(seq) if is_tuple else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _to_host(leaf):
    """``(C-contiguous numpy array as stored, true dtype name or None)``:
    a bfloat16 tensor goes as its ``u2`` bits (numpy has no bfloat16)."""
    name = None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            name, t = "bfloat16", t.view(torch.int16)
        a = t.cpu().numpy()
        if name is not None:
            a = a.view(np.uint16)
    else:
        a = np.asarray(leaf)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    return a, name


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF


_POLY = 0xEDB88320          # CRC-32, bit-reflected (zlib's)


def _mulmodp(a: int, b: int) -> int:
    """``a * b`` modulo the CRC-32 polynomial (zlib's ``multmodp``)."""
    m, p = 1 << 31, 0
    while m:
        if a & m:
            p ^= b
            if not a & (m - 1):
                break
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1
    return p


def _x8n(n: int) -> int:
    """x^(8n) modulo the polynomial: ``n`` bytes' shift (zlib's
    ``x2nmodp(n, 3)``)."""
    p, sq = 1 << 31, 1 << 30             # x^0; x^(2^k) from k = 0
    for _ in range(3):
        sq = _mulmodp(sq, sq)
    while n:
        if n & 1:
            p = _mulmodp(sq, p)
        n >>= 1
        sq = _mulmodp(sq, sq)
    return p


def _write(zf: zipfile.ZipFile, key: str, a: np.ndarray) -> int:
    """Write the C-contiguous ``a`` as the member ``key.npy`` (an npy
    header, then ``a``'s buffer as it is) and return the crc32 of ``a``'s
    bytes: the zip's own crc of the member with the header's taken out
    (zlib's ``crc32_combine`` solved for the second part), so the bytes
    are read once, not twice."""
    head = io.BytesIO()
    meta = np.lib.format.header_data_from_array_1_0(a)
    try:
        np.lib.format.write_array_header_1_0(head, meta)
    except ValueError:                    # a header over 64 KiB
        head = io.BytesIO()
        np.lib.format.write_array_header_2_0(head, meta)
    header = head.getvalue()
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        f.write(header)
        f.write(a.reshape(-1).view(np.uint8))
    whole = zf.getinfo(key + ".npy").CRC
    return whole ^ _mulmodp(_x8n(a.nbytes), zlib.crc32(header))


def _json_array(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _spec_table(specs) -> dict:
    """Each leaf's ``PartitionSpec`` under its checkpoint key (a spec is a
    tuple: a leaf here, never a sequence to flatten)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            out[prefix.rstrip("/")] = node
    if specs is not None:
        walk(specs, "")
    return out


def _device(tree):
    """The device of the tree's first tensor (the agreement collectives'
    device: gloo takes either, NCCL the card's)."""
    for _, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _agree_all(mesh, values, what: str, device) -> None:
    """Every rank of ``mesh`` holds the same ``values`` (or all raise),
    which also holds each rank until every rank has arrived."""
    from repro_torch.parallel import comm
    comm.agree(values, mesh.group(mesh.axis_names), what, device)


def _whole_leaves(tree, step, specs, mesh):
    """``(key, leaf)`` in the file's order, each sharded leaf gathered
    whole on rank 0 (every rank takes part in every gather, in the same
    order; the others get None)."""
    table = _spec_table(specs)
    for key, leaf in [*_flatten(tree), ("__step__", np.asarray(step))]:
        spec = table.get(key)
        if mesh is not None and spec is not None and mentioned(spec) and \
                isinstance(leaf, torch.Tensor):
            leaf = gather_to_first(leaf.detach(), spec, mesh)
        yield key, leaf


def save_checkpoint(path: str, tree, step: int = 0, specs=None,
                    mesh=None) -> str:
    """Atomically write ``tree`` (+ step) to ``path`` (.npz), one leaf on
    the host at a time.  On ``mesh`` (``tree`` this rank's shards,
    ``specs`` their specs) each leaf is gathered whole and rank 0 writes
    the file; every rank returns once it is in place."""
    leaves = _whole_leaves(tree, step, specs, mesh)
    if mesh is not None and mesh.rank != 0:
        for _ in leaves:              # this rank's part of each gather
            pass
    else:
        _write_npz(path, leaves)
    if mesh is not None:
        _agree_all(mesh, [step], f"the step saved to {path}", _device(tree))
    return path


def _write_npz(path: str, leaves) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        exotic, manifest = {}, {}
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, leaf in leaves:
                a, name = _to_host(leaf)
                del leaf
                if name is not None:
                    exotic[key] = name
                # crc32 over exactly the bytes that hit disk (the bit
                # carriers), so a flipped bit is caught with its key named
                manifest[key] = _write(zf, key, a)
                del a
            _write(zf, "__dtypes__", _json_array(exotic))
            _write(zf, "__manifest__", _json_array(manifest))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _StoredNpz:
    """Read access to an npz whose members are stored, not compressed (as
    ``np.savez`` and :func:`save_checkpoint` write them): each member is
    parsed in place in one copy-on-write memory map of the file, so a
    leaf is a view that reads the page cache when it is used, with no copy
    through ``zipfile``'s reader.  ``files`` and ``[key]`` as ``np.load``'s
    ``NpzFile``; integrity is the manifest's job (the zip's own crc is not
    read)."""

    _HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}

    def __init__(self, path: str):
        with zipfile.ZipFile(path) as zf:
            self._info = {i.filename[:-4]: i for i in zf.infolist()
                          if i.filename.endswith(".npy")}
        self.files = list(self._info)
        self._mm = np.memmap(path, dtype=np.uint8, mode="c")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._mm = None

    def __getitem__(self, key: str) -> np.ndarray:
        info, mm = self._info[key], self._mm
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"member {info.filename} is compressed")
        h = info.header_offset
        local = mm[h:h + 30].tobytes()
        if len(local) != 30 or local[:4] != b"PK\x03\x04":
            raise ValueError(f"no local file header at byte {h}")
        n_name, n_extra = struct.unpack("<HH", local[26:30])
        start = h + 30 + n_name + n_extra
        end = start + info.file_size
        if end > len(mm):
            raise ValueError("member runs past the end of the file")
        fp = io.BytesIO(mm[start:min(end, start + 65536)].tobytes())
        shape, fortran, dtype = self._HEADERS[
            np.lib.format.read_magic(fp)](fp)
        offset = start + fp.tell()
        if dtype.hasobject or offset + math.prod(shape) * dtype.itemsize \
                > end:
            raise ValueError(f"member {info.filename}: {dtype} {shape} "
                             f"does not fit its {info.file_size} bytes")
        return np.ndarray(shape, dtype, buffer=mm, offset=offset,
                          order="F" if fortran else "C")


def _read(z, key: str, path: str) -> np.ndarray:
    try:
        return z[key]
    except Exception as e:  # noqa: BLE001 — zipfile/np errors vary by version
        raise CheckpointCorruptError(
            f"checkpoint {path}: leaf {key!r} is unreadable: {e!r}") from e


def _json_leaf(z, key: str, path: str):
    return json.loads(bytes(_read(z, key, path).tobytes()).decode())


def _torch_leaf(a: np.ndarray, name) -> torch.Tensor:
    """A stored array as a CPU tensor of its true dtype (bit-exact)."""
    if name is None:
        return torch.from_numpy(a)
    if name != "bfloat16":
        raise ValueError(f"leaf dtype {name!r}: the port stores bfloat16 "
                         f"only in a bit carrier")
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def load_checkpoint(path: str, into=None, verify: bool = True, specs=None,
                    mesh=None):
    """``(tree, step)`` from ``path``.

    ``into=None`` returns a new tree of CPU tensors (lists and tuples as
    saved).  ``into`` (a tree of live tensors with the saved layout) is
    restored IN PLACE, under ``no_grad``, and returned: tensor identity,
    device and ``requires_grad`` stay.  With ``mesh`` and ``specs``,
    ``into`` holds this rank's shards: the file must hold their full
    shapes, and each takes its ``local_shard`` of the stored leaf.

    ``verify=True`` (default) checks every leaf against the embedded
    crc32 manifest when one is present; mismatches — and truncated or
    otherwise unreadable files — raise :class:`CheckpointCorruptError`
    with the offending keys named, before any live tensor is written.  On
    a mesh (every rank calls it) each rank checks every R-th leaf and
    the ranks' verdicts are all-gathered, so all raise together."""
    try:
        z = _StoredNpz(path)
    except Exception as e:  # noqa: BLE001 — zipfile/np errors vary by version
        raise CheckpointCorruptError(
            f"checkpoint {path} is unreadable (truncated or corrupt "
            f"container): {e!r}") from e
    with z:
        keys = [k for k in z.files if k not in _SPECIAL]
        want = _json_leaf(z, "__manifest__", path) \
            if "__manifest__" in z.files else None
        dtypes = _json_leaf(z, "__dtypes__", path) \
            if "__dtypes__" in z.files else {}
        # pass 1: every leaf once, one on the host at a time; on a mesh
        # rank r reads the bytes of leaves r, r + R, ... only
        split = mesh is not None and into is not None and mesh.size > 1
        meta, bad = {}, []
        for i, k in enumerate(keys + [k for k in ("__step__",)
                                      if k in z.files]):
            a = _read(z, k, path)
            meta[k] = (a.shape, dtypes.get(k, a.dtype))
            if verify and want is not None and (
                    not split or i % mesh.size == mesh.rank) and \
                    want.get(k) != _crc(a):
                bad.append(k)
            del a
        if verify and want is not None:
            bad += [k for k in want if k not in meta]
            # every rank takes part, so all raise or none does
            if split and _any_rank_bad(mesh, len(bad), _device(into)) \
                    and not bad:
                bad = ["(found by another rank)"]
            if bad:
                raise CheckpointCorruptError(
                    f"checkpoint {path} failed integrity verification; "
                    f"corrupt/missing leaves: {sorted(bad)[:8]}"
                    + (" ..." if len(bad) > 8 else ""))
        step = int(_read(z, "__step__", path)) if "__step__" in meta else 0
        if into is None:
            flat = {k: _torch_leaf(np.array(_read(z, k, path)),
                                   dtypes.get(k)) for k in keys}
            return _unflatten(flat), step
        live = dict(_flatten(into))
        table = _spec_table(specs) if mesh is not None else {}
        _check_layout(live, meta, path, table, mesh)
        # pass 2: the file verified and matches ``into``: overwrite
        with torch.no_grad():
            for k, t in live.items():
                if isinstance(t, torch.Tensor):
                    a = _read(z, k, path)
                    if k in table:
                        a = local_shard(a, table[k], mesh)
                    t.copy_(_torch_leaf(a, dtypes.get(k)))
        return into, step


def _any_rank_bad(mesh, n_bad: int, device) -> bool:
    """Whether any rank of ``mesh`` found a corrupt leaf (one
    all-gather)."""
    from repro_torch.parallel import comm
    counts = comm.all_gather(torch.tensor([n_bad], device=device),
                             mesh.group(mesh.axis_names), 0)
    return bool(counts.any())


def _full_shape(t, spec, mesh) -> tuple:
    """The whole array's shape of ``t``, this rank's block under
    ``spec``."""
    if spec is None:
        return tuple(t.shape)
    entries = list(spec) + [None] * (t.dim() - len(spec))
    return tuple(n * axis_size(mesh, e) for n, e in zip(t.shape, entries))


def _check_layout(live: dict, meta: dict, path: str, table=None,
                  mesh=None) -> None:
    """Refuse (ValueError) a file whose keys, shapes or dtypes differ from
    the live tree's (on a mesh: the live shards' full shapes), before
    anything is copied."""
    saved = {k for k in meta if k != "__step__"}
    if saved != set(live):
        raise ValueError(
            f"checkpoint {path} does not fit the live tree: only in the "
            f"file {sorted(saved - set(live))[:8]}, only in the tree "
            f"{sorted(set(live) - saved)[:8]}")
    for k, t in live.items():
        if not isinstance(t, torch.Tensor):
            continue
        shape, dt = meta[k]
        got = torch.bfloat16 if dt == "bfloat16" else \
            torch.from_numpy(np.zeros(0, dt)).dtype
        full = _full_shape(t, (table or {}).get(k), mesh)
        if tuple(shape) != full or got != t.dtype:
            raise ValueError(
                f"checkpoint {path}: leaf {k!r} is {dt} {tuple(shape)}, "
                f"the live tensor {t.dtype} {full}")


class CheckpointStore:
    """Retained-last-k checkpoint directory with corruption fallback.

    Writes step-tagged siblings ``<prefix>.step<N>.npz`` next to (or
    under) ``base``, each via :func:`save_checkpoint` (atomic tmp +
    ``os.replace``, embedded crc manifest), pruning to the newest
    ``retain`` files.  :meth:`restore` walks newest -> oldest, skipping
    files that fail verification — one corrupt newest checkpoint costs
    one retained step of progress, never the run.

    ``base`` may be a directory (files land inside, prefix ``ckpt``) or
    a file path like ``out/run.npz`` (siblings ``out/run.step42.npz``).
    """

    def __init__(self, base: str, retain: int = 3, faults=None):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        base = os.path.abspath(base)
        if os.path.isdir(base) or base.endswith(os.sep) or not \
                os.path.splitext(base)[1]:
            self.dir, self.prefix = base, "ckpt"
        else:
            self.dir = os.path.dirname(base)
            self.prefix = os.path.splitext(os.path.basename(base))[0]
        self.retain = int(retain)
        self.faults = faults              # FaultPlan (ckpt_bitflip) or None
        self.n_saves = 0

    def path_of(self, step: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}.step{step:08d}.npz")

    def _step_of(self, path: str):
        m = re.search(r"\.step(\d+)\.npz$", path)
        return int(m.group(1)) if m else None

    def steps(self) -> list:
        """Retained steps on disk, oldest first."""
        pat = os.path.join(glob.escape(self.dir),
                           glob.escape(self.prefix) + ".step*.npz")
        return sorted(s for s in (self._step_of(p) for p in glob.glob(pat))
                      if s is not None)

    def save(self, tree, step: int, specs=None, mesh=None) -> str:
        """Atomically write ``tree`` at ``step`` and prune beyond
        ``retain``.  The fault hook (``ckpt_bitflip``) corrupts the
        freshly written file in place — exercising exactly the restore
        fallback a real partial write would need.  On ``mesh`` (``tree``
        this rank's shards under ``specs``) rank 0 alone writes, flips
        and prunes, and every rank returns once it has."""
        path = save_checkpoint(self.path_of(step), tree, step, specs=specs,
                               mesh=mesh)
        self.n_saves += 1
        if mesh is None or mesh.rank == 0:
            if self.faults is not None and self.faults.ckpt_corrupts(
                    self.n_saves):
                off = self.faults.flip_bit(path)
                print(f"[faults] ckpt_bitflip: corrupted byte {off} of "
                      f"{os.path.basename(path)}", flush=True)
            for s in self.steps()[:-self.retain]:
                os.unlink(self.path_of(s))
        if mesh is not None:
            _agree_all(mesh, [step, self.n_saves],
                       "the retained checkpoints", _device(tree))
        return path

    def restore(self, into=None, specs=None, mesh=None):
        """Newest verified checkpoint as ``(tree, step, path)``, restored
        in place into ``into`` when given; corrupt files are reported and
        skipped (they never touch ``into``).  Raises
        ``FileNotFoundError`` when nothing is restorable.  On ``mesh``
        every rank reads the file into its shards (``load_checkpoint``),
        and all must restore the same step, or all raise."""
        errors, found = [], None
        for s in reversed(self.steps()):
            path = self.path_of(s)
            try:
                tree, step = load_checkpoint(path, into=into, specs=specs,
                                             mesh=mesh)
                found = tree, step, path
                break
            except CheckpointCorruptError as e:
                errors.append(str(e))
                print(f"[ckpt] {os.path.basename(path)} corrupt, falling "
                      f"back to previous retained checkpoint: {e}",
                      flush=True)
        if mesh is not None:
            _agree_all(mesh, [found[1] if found else -1],
                       "the restored checkpoint step",
                       _device(into) if into is not None else "cpu")
        if found is None:
            raise FileNotFoundError(
                f"no restorable checkpoint under {self.dir} "
                f"(prefix {self.prefix!r})"
                + (f"; {len(errors)} corrupt" if errors else ""))
        return found
