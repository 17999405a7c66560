"""Write-ahead journal for the serving frontend (crash consistency).

The port's copy of the reference's ``repro/runtime/journal.py``, with its
record format. Between snapshots, every state-mutating event of the serve
loop — a ``submit`` accepted into the ticket table, and each completed
scheduler ``round`` with its observed events (admissions with the trie
paths and slots they claimed, preemptions, completions, decode-chunk
boundaries with emitted token counts) — is appended here and fsync'd.
Recovery (``runtime/recovery.DurableFrontend``) then is:

    load latest valid snapshot  ->  replay the journal tail  ->  resume.

Record format — one line per record:

    <seq> <crc32-of-payload:08x> <payload-json>\n

``seq`` increases from 0 within one journal file; the CRC covers the JSON
payload bytes. ``read`` stops at the FIRST torn or corrupt line (a partial
tail write at crash time, or the injected ``journal_truncate`` fault) or
sequence break and reports the file as not clean: records before the tear
are trusted, everything after is not.

One journal file per snapshot EPOCH: ``journal_<round:09d>.log`` holds the
records after the snapshot taken at ``round``. Recovery that falls back
past a corrupt snapshot chains the epoch files back together.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import List, Tuple


class Journal:
    """Append-only, CRC-guarded, fsync'd event log (one epoch file)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # "a" keeps any existing records: reopening an epoch after a
        # crash-without-recovery must not clobber the tail being replayed.
        self._f = open(path, "a", encoding="utf-8")
        self.seq = self._existing_seq()

    def _existing_seq(self) -> int:
        records, _ = Journal.read(self.path)
        return len(records)

    def append(self, record: dict):
        """Durably append one record: the call returns only after the
        bytes are flushed AND fsync'd — the WAL guarantee that a record
        observed in memory is recoverable from disk."""
        payload = json.dumps(record, separators=(",", ":"))
        line = f"{self.seq} {zlib.crc32(payload.encode()):08x} {payload}\n"
        self._f.write(line)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.seq += 1

    def close(self):
        if not self._f.closed:
            self._f.close()

    @staticmethod
    def compact(path: str) -> int:
        """Rewrite ``path`` keeping only its clean record prefix.

        A torn tail (crash mid-write, injected ``journal_truncate``) is
        tolerated by ``read`` — but APPENDING after the tear would bury
        the new records behind bytes ``read`` refuses to cross. When an
        epoch must be re-opened for further appends (recovery that
        cannot snapshot yet), compact it first: the clean records are
        re-serialised atomically, the torn bytes are dropped, and new
        appends chain on readably. Returns the number of records kept.
        A clean (or missing) file is left untouched."""
        records, clean = Journal.read(path)
        if clean:
            return len(records)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for seq, rec in enumerate(records):
                payload = json.dumps(rec, separators=(",", ":"))
                f.write(f"{seq} {zlib.crc32(payload.encode()):08x} "
                        f"{payload}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(records)

    @staticmethod
    def read(path: str) -> Tuple[List[dict], bool]:
        """Parse a journal file -> (records, clean).

        Stops at the first line that is torn (no trailing newline),
        malformed, fails its CRC, or breaks the seq sequence; ``clean``
        is False iff any bytes were abandoned. Missing file reads as
        (no records, clean) — an epoch with nothing after its snapshot."""
        if not os.path.exists(path):
            return [], True
        with open(path, "rb") as f:
            raw = f.read()
        records: List[dict] = []
        pos = 0
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            if nl < 0:
                return records, False  # torn tail: no newline
            line = raw[pos:nl]
            try:
                seq_s, crc_s, payload = line.split(b" ", 2)
                if int(seq_s) != len(records):
                    return records, False
                if int(crc_s, 16) != zlib.crc32(payload):
                    return records, False
                records.append(json.loads(payload.decode("utf-8")))
            except (ValueError, json.JSONDecodeError):
                return records, False
            pos = nl + 1
        return records, True


__all__ = ["Journal"]
