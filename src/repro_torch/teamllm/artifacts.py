"""Immutable append-only artifact store (paper §3.1 invariant 2).

Artifacts are stored as hash-chained JSONL (``runs.jsonl``): each line
carries the record, its content hash, and the chain hash
``H(prev_chain | record_hash)``. Existing records cannot be altered —
the store verifies the chain on open and refuses to append to a
corrupted file. "Modification" means appending a new versioned record.

Crash safety: ``stable_json`` output contains no newlines and each
append writes ``line + "\n"`` in one call followed by flush + fsync,
so a complete record always ends in a newline and a file whose final
byte is *not* a newline can only be a torn final append (the process
died mid-write). Opening the store truncates such a torn tail back to
the last complete line before verifying — the chain is intact up to
the last durable record. A *complete* final line whose hashes do not
verify is tampering, not tearing, and still raises
``ChainCorruption``.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.teamllm.trace import TraceRecord, content_hash, stable_json

GENESIS = "0" * 64


class ChainCorruption(RuntimeError):
    pass


class ArtifactStore:
    """Append-only, hash-chained JSONL store."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._chain = GENESIS
        self._count = 0
        self.torn_recovered = False
        if self.path.exists():
            self._recover_torn()
            self._chain, self._count = self._verify()

    def _recover_torn(self) -> None:
        """Truncate a torn final line (kill mid-append). Appends write
        whole newline-terminated lines atomically from the reader's
        perspective, so a file not ending in ``\\n`` holds exactly one
        partial record at its tail and nothing else is suspect."""
        data = self.path.read_bytes()
        if not data or data.endswith(b"\n"):
            return
        keep = data.rfind(b"\n") + 1
        with self.path.open("r+b") as f:
            f.truncate(keep)
            f.flush()
            os.fsync(f.fileno())
        self.torn_recovered = True

    # -- chain ---------------------------------------------------------
    @staticmethod
    def _link(prev: str, record_hash: str) -> str:
        return hashlib.sha256(f"{prev}|{record_hash}".encode()).hexdigest()

    def _verify(self) -> tuple:
        chain = GENESIS
        n = 0
        with self.path.open() as f:
            for i, line in enumerate(f):
                row = json.loads(line)
                rh = content_hash(row["record"])
                if rh != row["record_hash"]:
                    raise ChainCorruption(
                        f"{self.path}:{i + 1}: record hash mismatch")
                chain = self._link(chain, rh)
                if chain != row["chain_hash"]:
                    raise ChainCorruption(
                        f"{self.path}:{i + 1}: chain hash mismatch")
                n += 1
        return chain, n

    # -- API -----------------------------------------------------------
    def _encode(self, record: Union[TraceRecord, Dict[str, Any]],
                wall_time: Optional[float] = None
                ) -> Tuple[str, str]:
        """Serialise a record against the current chain state without
        mutating it: returns (newline-terminated line, new chain
        head). Split from ``append`` so the in-memory state only moves
        once the bytes are durable."""
        schedule = None
        if isinstance(record, TraceRecord):
            hashed = record.hashed_view()
            wall = record.wall_time
            schedule = record.schedule
        else:
            hashed = dict(record)
            wall = hashed.pop("wall_time", 0.0)
            schedule = hashed.pop("schedule", None)
        if wall_time is not None:
            wall = wall_time
        rh = content_hash(hashed)
        chain = self._link(self._chain, rh)
        row = {
            "record": hashed,
            "record_hash": rh,
            "chain_hash": chain,
            "wall_time": wall or time.time(),
        }
        if schedule is not None:
            # non-hashed side channel, like wall_time: queue/batch
            # provenance is auditable but does not perturb the chain
            row["schedule"] = schedule
        return stable_json(row) + "\n", chain

    def append(self, record: Union[TraceRecord, Dict[str, Any]],
               wall_time: Optional[float] = None) -> str:
        """Append a record; returns its chain hash. The line is
        written, flushed and fsync'd in one go before the chain state
        advances — a kill anywhere leaves at worst a torn tail that
        ``_recover_torn`` truncates on the next open."""
        line, chain = self._encode(record, wall_time)
        with self.path.open("a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self._chain = chain
        self._count += 1
        return self._chain

    def __len__(self) -> int:
        return self._count

    @property
    def head(self) -> str:
        return self._chain

    def records(self) -> Iterator[Dict[str, Any]]:
        if not self.path.exists():
            return
        with self.path.open() as f:
            for line in f:
                yield json.loads(line)["record"]

    def read_all(self) -> List[Dict[str, Any]]:
        return list(self.records())

    def audit(self) -> Dict[str, Any]:
        """Full-chain audit report (paper appendix: zero parse errors)."""
        chain, n = self._verify() if self.path.exists() else (GENESIS, 0)
        return {
            "path": str(self.path),
            "records": n,
            "head": chain,
            "parse_errors": 0,  # _verify raises on any corruption
            "ok": chain == self._chain and n == self._count,
        }
