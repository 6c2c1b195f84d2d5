"""Buffered streaming JSONL event sink with run-metadata header and
size-based rotation (a copy of ``repro/obs/sink.py``, which is
framework-free, but for :func:`_coerce`'s refusal of device tensors).

Layout under ``metrics_dir``::

    metrics-000.jsonl     # first line: {"event": "meta", ...}, then events
    metrics-001.jsonl     # after rotation (each file re-carries the header)

Every line is one self-contained JSON object with at least ``event``
(name), ``t`` (seconds since sink creation, monotonic) and ``seq``
(global event ordinal — survives rotation, so readers can re-merge a
rotated run in order).  Values must be JSON-serializable; numpy scalars
and CPU tensors are coerced via ``item()``/``tolist()`` fallbacks.  A
tensor on a card is refused: reading it would wait for the device, and
no event may cost a sync, so emitters pass values the host already
holds.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


def _coerce(v):
    """Best-effort JSON coercion for numpy scalars and CPU tensors."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if getattr(v, "is_cuda", False):
        raise TypeError("obs: an event field is a tensor on the card; "
                        "emit a value the host already holds")
    if isinstance(v, dict):
        return {str(k): _coerce(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_coerce(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return _coerce(item())
        except Exception:
            pass
    tolist = getattr(v, "tolist", None)   # numpy arrays, CPU tensors
    if callable(tolist):
        try:
            return _coerce(tolist())
        except Exception:
            pass
    try:
        return float(v)
    except Exception:
        return str(v)


class JsonlSink:
    """Append-only JSONL event writer.

    Parameters
    ----------
    metrics_dir:
        Directory to create/write files under.
    meta:
        Run metadata dict written as the first ``{"event": "meta"}``
        line of every file (config, mesh shape, argv, ...).
    rotate_bytes:
        Rotate to a new file once the current one passes this size.
    buffer_events:
        Events held in memory between writes (1 = unbuffered).
    """

    def __init__(self, metrics_dir: str, meta: Optional[dict] = None,
                 rotate_bytes: int = 64 * 1024 * 1024,
                 buffer_events: int = 64) -> None:
        self.dir = str(metrics_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.meta = dict(meta or {})
        self.rotate_bytes = int(rotate_bytes)
        self.buffer_events = max(1, int(buffer_events))
        self._t0 = time.monotonic()
        self._seq = 0
        self._file_index = -1
        self._bytes = 0
        self._buf: List[str] = []
        self._fh = None
        self._paths: List[str] = []
        self._closed = False
        self._open_next()

    # -- file management ------------------------------------------------

    def _open_next(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._file_index += 1
        path = os.path.join(self.dir, f"metrics-{self._file_index:03d}.jsonl")
        self._fh = open(path, "w")
        self._paths.append(path)
        header = {"event": "meta", "t": self._now(), "seq": self._seq,
                  "file_index": self._file_index}
        for k, v in self.meta.items():   # reserved keys win on collision
            if k not in header:
                header[k] = _coerce(v)
        line = json.dumps(header) + "\n"
        self._fh.write(line)
        self._bytes = len(line.encode("utf-8"))
        self._seq += 1

    @property
    def paths(self) -> List[str]:
        """All files written so far, in rotation order."""
        return list(self._paths)

    @property
    def path(self) -> str:
        """The file currently being written."""
        return self._paths[-1]

    def _now(self) -> float:
        return round(time.monotonic() - self._t0, 6)

    # -- event API ------------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        if self._closed:
            return
        rec: Dict[str, object] = {"event": event, "t": self._now(),
                                  "seq": self._seq}
        self._seq += 1
        for k, v in fields.items():      # reserved keys win on collision
            if k not in ("event", "t", "seq"):
                rec[k] = _coerce(v)
        self._buf.append(json.dumps(rec) + "\n")
        if len(self._buf) >= self.buffer_events:
            self.flush()

    def flush(self) -> None:
        if self._closed or not self._buf:
            return
        chunk = "".join(self._buf)
        self._buf.clear()
        self._fh.write(chunk)
        self._fh.flush()
        self._bytes += len(chunk.encode("utf-8"))
        if self._bytes >= self.rotate_bytes:
            self._open_next()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._closed = True

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(paths) -> List[dict]:
    """Parse one or more JSONL files back into event dicts (in seq
    order across rotated files).  Test/report helper, not a hot path."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    events: List[dict] = []
    for p in paths:
        with open(p) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    events.append(json.loads(line))
    events.sort(key=lambda e: e.get("seq", 0))
    return events
