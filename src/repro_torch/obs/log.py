"""Structured event logging: JSON-lines records, buffered + streamable.

The serving and benchmark paths emit *events* (wave admitted, tenant
registered, profile captured) rather than printf strings, so a consumer
-- the regression gate, a notebook, `jq` -- can filter on fields instead
of parsing prose.

Every record is one JSON object: ``{"ts": ..., "event": ..., **fields}``.
Records are kept in an in-memory ring (for tests and the `events()`
accessor) and, when a stream or path is configured, mirrored as JSON
lines to it.
"""
from __future__ import annotations

import io
import json
import threading
import time
from typing import Dict, List, Optional


class EventLog:
    def __init__(self, stream: Optional[io.TextIOBase] = None,
                 max_records: int = 4096):
        self._stream = stream
        self._records: List[Dict] = []
        self._max = int(max_records)
        self._lock = threading.Lock()

    def configure(self, *, stream=None, path: Optional[str] = None) -> None:
        """Attach a mirror stream (or a file path opened in append mode)."""
        if stream is not None and path is not None:
            raise ValueError("pass stream or path, not both")
        if path is not None:
            stream = open(path, "a")
        self._stream = stream

    def emit(self, event: str, **fields) -> Dict:
        rec = {"ts": round(time.time(), 6), "event": event, **fields}
        line = json.dumps(rec, default=str, sort_keys=True)
        with self._lock:
            self._records.append(rec)
            if len(self._records) > self._max:
                del self._records[: len(self._records) - self._max]
            if self._stream is not None:
                self._stream.write(line + "\n")
                self._stream.flush()
        return rec

    def events(self, event: Optional[str] = None) -> List[Dict]:
        with self._lock:
            recs = list(self._records)
        if event is None:
            return recs
        return [r for r in recs if r["event"] == event]

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


_DEFAULT = EventLog()


def get_event_log() -> EventLog:
    return _DEFAULT


def log_event(event: str, **fields) -> Dict:
    """Emit onto the process-wide default log."""
    return _DEFAULT.emit(event, **fields)
