"""Port of `nos_tpu/analysis/cache.py:1` (:1-176). Copied near verbatim; the
imports point at the port, which imports nothing of the JAX package. The
cache file has a basename of its own (`CACHE_BASENAME`, :36): both analyzers
run from the repository root, and one file shared under two package salts
would make each throw the other's cache away.

Content-hash-keyed incremental cache for the lint engine.

Tier-1 suite runtime is an explicit budget (ROADMAP: "treat suite runtime as
a real budget"), and `nos-tpu-torch lint` would re-parse and re-traverse the
whole tree on every run. The cache splits a run's cost along the same line
the engine splits its checkers:

  - **per-file** entries: a file's raw local findings (pre-inline-ignore,
    pre-baseline), keyed by the file's content hash. Unchanged file ->
    findings reused, file never parsed.
  - **one cross-file** entry: the combined findings of every cross-file
    checker (lock graph, protocol round-trip, replay purity, telemetry
    schema), keyed by a digest over ALL discovered (rel, sha) pairs plus
    each checker's declared `extra_inputs()` (e.g. docs/telemetry.md —
    inputs that are not .py files but still feed findings).

Both are salted with a hash of the analysis package's own sources and the
active `--select`, so editing any checker invalidates everything — a cache
can never mask a checker change. Raw findings are cached; inline ignores,
unused-suppression findings (NOS023) and the baseline are recomputed from
source on every run (the sources are read anyway to hash them), so a warm
run is byte-identical to a cold one by construction. `--no-cache` bypasses
the whole mechanism.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from nos_tpu_torch.analysis.core import Finding

CACHE_BASENAME = ".nos-lint-cache-torch.json"
_VERSION = 1


def content_sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def package_salt(select: Optional[Iterable[str]] = None) -> str:
    """Hash of every .py source in the analysis package + the select set:
    the checkers ARE inputs to the findings, so editing one must invalidate
    every cached verdict."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, pkg_dir).replace(os.sep, "/").encode())
            try:
                with open(path, "rb") as f:
                    h.update(f.read())
            except OSError:  # pragma: no cover - racing an editor
                h.update(b"?")
    h.update(repr(sorted(select) if select is not None else None).encode())
    return h.hexdigest()


def crossfile_key(
    file_shas: Iterable[Tuple[str, str]], extra_inputs: Iterable[str]
) -> str:
    """Digest of the whole analyzed tree + non-.py checker inputs: the
    invalidation key for interprocedural findings."""
    h = hashlib.sha256()
    for rel, sha in sorted(file_shas):
        h.update(rel.encode())
        h.update(b"=")
        h.update(sha.encode())
        h.update(b"\n")
    for path in sorted(set(extra_inputs)):
        h.update(path.encode())
        h.update(b":")
        try:
            with open(path, "rb") as f:
                h.update(hashlib.sha256(f.read()).digest())
        except OSError:
            h.update(b"<missing>")
        h.update(b"\n")
    return h.hexdigest()


def _dump(findings: Sequence[Finding]) -> List[List]:
    return [[f.path, f.line, f.code, f.message] for f in findings]


def _load_findings(rows) -> Optional[List[Finding]]:
    try:
        return [Finding(str(p), int(ln), str(c), str(m)) for p, ln, c, m in rows]
    except (TypeError, ValueError):
        return None


class LintCache:
    """One JSON file under the lint root. Any decode problem, version skew
    or salt mismatch degrades to an empty (cold) cache — the cache can slow
    a run down, never corrupt it."""

    def __init__(self, path: str, salt: str):
        self.path = path
        self.salt = salt
        self._files: Dict[str, dict] = {}
        self._cross: Optional[dict] = None
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(data, dict):
            return
        if data.get("version") != _VERSION or data.get("salt") != self.salt:
            return
        files = data.get("files")
        if isinstance(files, dict):
            self._files = files
        cross = data.get("crossfile")
        if isinstance(cross, dict):
            self._cross = cross

    # -- per-file local findings --------------------------------------------
    def get_file(self, rel: str, sha: str) -> Optional[List[Finding]]:
        entry = self._files.get(rel)
        if not isinstance(entry, dict) or entry.get("sha") != sha:
            return None
        return _load_findings(entry.get("findings", ()))

    def set_file(self, rel: str, sha: str, findings: Sequence[Finding]) -> None:
        self._files[rel] = {"sha": sha, "findings": _dump(findings)}
        self._dirty = True

    # -- cross-file findings -------------------------------------------------
    def get_crossfile(self, key: str) -> Optional[List[Finding]]:
        if not isinstance(self._cross, dict) or self._cross.get("key") != key:
            return None
        return _load_findings(self._cross.get("findings", ()))

    def set_crossfile(self, key: str, findings: Sequence[Finding]) -> None:
        self._cross = {"key": key, "findings": _dump(findings)}
        self._dirty = True

    # -- persistence ---------------------------------------------------------
    def prune(self, keep_rels: Iterable[str]) -> None:
        keep = set(keep_rels)
        stale = [rel for rel in self._files if rel not in keep]
        for rel in stale:
            del self._files[rel]
            self._dirty = True

    def write(self) -> None:
        if not self._dirty:
            return
        data = {
            "version": _VERSION,
            "salt": self.salt,
            "files": self._files,
            "crossfile": self._cross,
        }
        directory = os.path.dirname(self.path) or "."
        try:
            fd, tmp = tempfile.mkstemp(prefix=CACHE_BASENAME, dir=directory)
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(data, f, separators=(",", ":"))
            os.replace(tmp, self.path)
        except OSError:  # read-only checkout: run uncached, silently
            pass
        self._dirty = False
