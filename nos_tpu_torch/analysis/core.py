"""Port of `nos_tpu/analysis/core.py:1` (:1-524). Copied near verbatim; the
imports point at the port, which imports nothing of the JAX package.

Two-phase AST analysis engine with an interprocedural layer.

Phase 1 parses every discovered file once and builds ONE whole-tree
`CallGraph` (callgraph.py): module/symbol resolution, conservative call
edges, and the `reachable_from` query every reachability-based checker now
shares. Phase 2 is the original single-pass fan-out: one recursive
traversal per file maintains an ancestor stack and hands every node to
every registered checker (the kube-scheduler framework idiom: one pass,
pluggable per-node plugins).

Checkers come in two kinds, and the split is what makes incremental runs
sound:

  - **local** (default): findings for a file depend only on that file's
    source (plus same-file call-graph queries, `within={ctx.rel}`). Their
    raw findings are cacheable per file by content hash.
  - **cross-file** (`cross_file = True`): findings depend on the whole
    tree (and any `extra_inputs()` such as docs). They only run when the
    tree digest changed, and then against ALL files. A checker that
    implements `finish` MUST set `cross_file = True` — the engine refuses
    otherwise rather than silently caching wrong results.

Inline suppression: a finding is dropped when its source line carries a
`# nos-lint: ignore[CODE]` (or blanket `# nos-lint: ignore`) comment.
Suppressions are themselves audited: an ignore that suppresses zero live
findings is a NOS023 finding (the inline mirror of the stale-baseline
gate), so healed code sheds its suppressions instead of accumulating
them. NOS023 only fires when the full checker registry is active (no
--select), and only for codes some active checker can emit — a
single-checker unit run must not call another checker's suppression
unused. File-level suppression with a rationale lives in the committed
baseline (see baseline.py) so the tree stays greppable for WHY a finding
is allowed.

Raw (pre-ignore, pre-baseline) findings are what the cache stores;
ignores, NOS023 and the baseline are recomputed from source every run, so
warm results are byte-identical to cold by construction.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from nos_tpu_torch.analysis.callgraph import CallGraph

_IGNORE_RE = re.compile(r"#\s*nos-lint:\s*ignore(?:\[([A-Z0-9, ]+)\])?")

#: Codes emitted by the engine itself rather than any checker.
ENGINE_CODES = ("NOS000", "NOS023")


@dataclass(frozen=True, order=True)
class Finding:
    """One structured finding: stable identity is (code, path, message) —
    line numbers churn with unrelated edits, so the baseline keys off the
    message, not the line."""

    path: str  # posix-style, relative to the engine root
    line: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


class FileContext:
    """Per-file traversal context handed to checkers on every visit."""

    def __init__(self, root: str, path: str, source: str, tree: ast.Module):
        self.root = root
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # Ancestor stack maintained by the engine during traversal:
        # stack[-1] is the direct parent of the node being visited.
        self.stack: List[ast.AST] = []

    @property
    def basename(self) -> str:
        return os.path.basename(self.path)

    @property
    def segments(self) -> Tuple[str, ...]:
        return tuple(self.rel.split("/"))

    def parent(self, depth: int = 1) -> Optional[ast.AST]:
        return self.stack[-depth] if len(self.stack) >= depth else None

    def enclosing(self, *types) -> Optional[ast.AST]:
        """Innermost ancestor of one of `types`, or None."""
        for node in reversed(self.stack):
            if isinstance(node, types):
                return node
        return None

    def enclosing_all(self, *types) -> List[ast.AST]:
        """All ancestors of the given types, innermost first."""
        return [n for n in reversed(self.stack) if isinstance(n, types)]

    def is_docstring(self, node: ast.AST) -> bool:
        """True when `node` is the docstring literal of its enclosing
        module/class/function (wire literals quoted in prose are fine)."""
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            return False
        p = self.parent()
        if not isinstance(p, ast.Expr):
            return False
        gp = self.parent(2)
        return (
            isinstance(gp, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and bool(gp.body)
            and gp.body[0] is p
        )


class Report:
    def __init__(self) -> None:
        self.findings: List[Finding] = []

    def add(self, rel: str, line: int, code: str, message: str) -> None:
        self.findings.append(Finding(rel, line, code, message))


class Checker:
    """Base class for domain checkers. Override any subset of the hooks;
    `codes` lists every finding code the checker can emit (used by --select
    and the docs).

    Set `cross_file = True` when findings depend on more than one file's
    source (anything using `finish`, whole-tree call-graph reachability, or
    non-.py inputs declared via `extra_inputs`). Local checkers may consult
    the call graph only for same-file queries (`within={ctx.rel}`) — the
    incremental cache reuses their findings per file, so depending on other
    files' content would go stale silently."""

    name = "checker"
    codes: Tuple[str, ...] = ()
    description = ""
    cross_file = False

    def extra_inputs(self) -> Sequence[str]:
        """Non-.py files (root-relative) whose content feeds this checker's
        findings; they join the cross-file cache key."""
        return ()

    def begin_run(self, graph: CallGraph) -> None:  # pragma: no cover - hook
        pass

    def begin_file(self, ctx: FileContext) -> None:  # pragma: no cover - hook
        pass

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        pass

    def end_file(self, ctx: FileContext, report: Report) -> None:  # pragma: no cover - hook
        pass

    def finish(self, report: Report) -> None:  # pragma: no cover - hook
        pass


@dataclass
class RunStats:
    """What one engine run actually did — the honesty backing for the
    cache's speedup claims (CLI timing line, cache-correctness tests)."""

    files: int = 0
    parsed: int = 0
    local_reused: int = 0
    local_computed: int = 0
    crossfile_reused: bool = False
    crossfile_computed: bool = False
    elapsed_s: float = 0.0

    def summary(self) -> str:
        cross = (
            "reused"
            if self.crossfile_reused
            else ("computed" if self.crossfile_computed else "n/a")
        )
        return (
            f"{self.files} files ({self.parsed} parsed, "
            f"{self.local_reused} reused from cache), cross-file {cross}, "
            f"{self.elapsed_s:.2f}s"
        )


@dataclass
class _FileEntry:
    path: str
    rel: str
    source: Optional[str]  # None when unreadable
    sha: str
    ctx: Optional[FileContext] = None
    parse_error: Optional[Finding] = None
    ignores: Dict[int, Optional[set]] = field(default_factory=dict)


class Engine:
    def __init__(self, checkers: Sequence[Checker], root: Optional[str] = None):
        self.checkers = list(checkers)
        self.root = os.path.abspath(root) if root else os.getcwd()
        self.stats = RunStats()
        for c in self.checkers:
            if not c.cross_file and type(c).finish is not Checker.finish:
                raise TypeError(
                    f"{type(c).__name__} implements finish() but is not "
                    "marked cross_file=True; its findings would be cached "
                    "per-file and go stale"
                )

    # -- discovery -----------------------------------------------------------
    @staticmethod
    def discover(paths: Iterable[str]) -> List[str]:
        out: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames if d != "__pycache__" and not d.startswith(".")
                    )
                    for f in sorted(filenames):
                        if f.endswith(".py"):
                            out.append(os.path.join(dirpath, f))
            elif p.endswith(".py"):
                out.append(p)
        return out

    # -- the run -------------------------------------------------------------
    def run(
        self,
        paths: Iterable[str],
        select: Optional[Iterable[str]] = None,
        cache=None,
    ) -> List[Finding]:
        t0 = time.perf_counter()
        checkers = self.checkers
        if select is not None:
            wanted = set(select)
            checkers = [c for c in checkers if wanted.intersection(c.codes)]
        local = [c for c in checkers if not c.cross_file]
        cross = [c for c in checkers if c.cross_file]

        # Phase 0: read + hash every file. Sources are needed for hashing
        # and ignore-scanning regardless of cache state, so reads are never
        # the saved cost — parsing and traversal are.
        entries: List[_FileEntry] = []
        for path in self.discover(paths):
            rel = os.path.relpath(path, self.root).replace(os.sep, "/")
            try:
                with open(path, "rb") as f:
                    raw = f.read()
                source = raw.decode("utf-8")
            except (OSError, UnicodeDecodeError) as e:
                entry = _FileEntry(path, rel, None, "")
                entry.parse_error = Finding(
                    rel, 1, "NOS000", f"unreadable file: {e.__class__.__name__}"
                )
                entries.append(entry)
                continue
            sha = hashlib.sha256(raw).hexdigest()
            entry = _FileEntry(path, rel, source, sha)
            entry.ignores = self._scan_ignores(source)
            entries.append(entry)
        self.stats = RunStats(files=len(entries))

        # Cache lookups: per-file local findings + the one cross-file blob.
        cached_local: Dict[str, List[Finding]] = {}
        if cache is not None:
            for e in entries:
                if e.source is None:
                    continue
                hit = cache.get_file(e.rel, e.sha)
                if hit is not None:
                    cached_local[e.rel] = hit
        cross_findings: Optional[List[Finding]] = None
        cross_key = None
        if cross:
            from nos_tpu_torch.analysis.cache import crossfile_key

            extras = [
                os.path.join(self.root, p) for c in cross for p in c.extra_inputs()
            ]
            cross_key = crossfile_key(
                ((e.rel, e.sha) for e in entries if e.source is not None), extras
            )
            if cache is not None:
                cross_findings = cache.get_crossfile(cross_key)
        else:
            cross_findings = []
        run_cross = cross_findings is None
        self.stats.crossfile_reused = bool(cross) and not run_cross
        self.stats.crossfile_computed = run_cross and bool(cross)

        # Phase 1: parse what this run actually needs — every file when the
        # cross-file checkers run, only the local cache misses otherwise —
        # and build the call graph over the parsed subset. (Local checkers
        # only make same-file graph queries, so a subset graph answers them
        # identically; cross-file checkers always get the full tree.)
        need_local = [e for e in entries if e.source is not None and e.rel not in cached_local]
        parse_set = [e for e in entries if e.source is not None] if run_cross else need_local
        for e in parse_set:
            try:
                tree = ast.parse(e.source, filename=e.path)
            except SyntaxError as exc:
                e.parse_error = Finding(
                    e.rel,
                    getattr(exc, "lineno", 1) or 1,
                    "NOS000",
                    f"unparseable file: {exc.__class__.__name__}",
                )
                continue
            e.ctx = FileContext(self.root, e.path, e.source, tree)
        self.stats.parsed = sum(1 for e in parse_set if e.ctx is not None)
        self.stats.local_reused = len(cached_local)
        self.stats.local_computed = len(need_local)

        graph = CallGraph((e.rel, e.ctx.tree) for e in parse_set if e.ctx is not None)
        running: List[Checker] = []
        if need_local:
            running.extend(local)
        if run_cross:
            running.extend(cross)
        for c in running:
            c.begin_run(graph)

        # Phase 2: the per-file fan-out. A file is traversed by the local
        # checkers when its findings are not cached, and by the cross-file
        # checkers when the tree digest missed.
        need_local_set = {e.rel for e in need_local}
        local_raw: Dict[str, List[Finding]] = {e.rel: [] for e in need_local}
        cross_report = Report()
        for e in entries:
            if e.parse_error is not None and e.rel in need_local_set:
                local_raw[e.rel].append(e.parse_error)
            if e.ctx is None:
                continue
            plan: List[Tuple[Checker, Report]] = []
            if e.rel in need_local_set:
                file_report = Report()
                plan.extend((c, file_report) for c in local)
            else:
                file_report = None
            if run_cross:
                plan.extend((c, cross_report) for c in cross)
            if not plan:
                continue
            for c, _ in plan:
                c.begin_file(e.ctx)
            self._walk(e.ctx, e.ctx.tree, plan)
            for c, rep in plan:
                c.end_file(e.ctx, rep)
            if file_report is not None:
                local_raw[e.rel].extend(file_report.findings)
        if run_cross:
            for c in cross:
                c.finish(cross_report)
            cross_findings = cross_report.findings

        # Cache write-back: raw findings only.
        if cache is not None:
            for e in need_local:
                cache.set_file(e.rel, e.sha, local_raw[e.rel])
            if cross and run_cross and cross_key is not None:
                cache.set_crossfile(cross_key, cross_findings or [])
            cache.prune(e.rel for e in entries)
            cache.write()

        # Merge raw findings, then apply inline ignores centrally so
        # suppression accounting sees cached and fresh findings alike.
        raw: List[Finding] = []
        for e in entries:
            if e.source is None and e.parse_error is not None:
                raw.append(e.parse_error)
        for rel in cached_local:
            raw.extend(cached_local[rel])
        for rel in local_raw:
            raw.extend(local_raw[rel])
        raw.extend(cross_findings or [])

        ignore_lines = {e.rel: e.ignores for e in entries}
        findings, used = self._apply_inline_ignores(raw, ignore_lines)
        if select is None:
            findings.extend(
                self._unused_suppressions(entries, used, checkers)
            )
        else:
            wanted = set(select)
            findings = [f for f in findings if f.code in wanted]
        self.stats.elapsed_s = time.perf_counter() - t0
        return sorted(set(findings))

    def _walk(
        self, ctx: FileContext, node: ast.AST, plan: Sequence[Tuple[Checker, Report]]
    ) -> None:
        for c, rep in plan:
            c.visit(ctx, node, rep)
        ctx.stack.append(node)
        for child in ast.iter_child_nodes(node):
            self._walk(ctx, child, plan)
        ctx.stack.pop()

    # -- inline ignores ------------------------------------------------------
    @staticmethod
    def _scan_ignores(source: str) -> Dict[int, Optional[set]]:
        """line number -> set of ignored codes (None = ignore everything).
        Only real COMMENT tokens count — a docstring that merely *mentions*
        the `# nos-lint: ignore[...]` syntax (every checker's does) is
        prose, not a suppression, and must not trip the NOS023 unused-
        suppression audit. The `nos-lint` substring check keeps the
        tokenizer off the overwhelmingly common no-suppression file."""
        if "nos-lint" not in source:
            return {}
        out: Dict[int, Optional[set]] = {}
        import io
        import tokenize

        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _IGNORE_RE.search(tok.string)
                if not m:
                    continue
                codes = m.group(1)
                out[tok.start[0]] = (
                    {c.strip() for c in codes.split(",")} if codes else None
                )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # Unparseable file: fall back to the line regex so suppression
            # still works next to whatever NOS000 points at.
            for i, line in enumerate(source.splitlines(), start=1):
                m = _IGNORE_RE.search(line)
                if not m:
                    continue
                codes = m.group(1)
                out[i] = {c.strip() for c in codes.split(",")} if codes else None
        return out

    @staticmethod
    def _apply_inline_ignores(
        findings: Sequence[Finding], ignore_lines
    ) -> Tuple[List[Finding], Set[Tuple[str, int, Optional[str]]]]:
        """Drop suppressed findings; also return which suppressions FIRED,
        as (path, line, code) triples (code None for a blanket entry), so
        unused ones can be flagged."""
        kept: List[Finding] = []
        used: Set[Tuple[str, int, Optional[str]]] = set()
        for f in findings:
            codes = ignore_lines.get(f.path, {}).get(f.line, "missing")
            if codes == "missing":
                kept.append(f)
            elif codes is None:
                used.add((f.path, f.line, None))
            elif f.code in codes:
                used.add((f.path, f.line, f.code))
            else:
                kept.append(f)
        return kept, used

    def _unused_suppressions(
        self,
        entries: Sequence[_FileEntry],
        used: Set[Tuple[str, int, Optional[str]]],
        checkers: Sequence[Checker],
    ) -> List[Finding]:
        """NOS023 for every inline ignore that suppressed nothing this run.
        Only codes some active checker can emit are audited — a suppression
        for a checker that is not running cannot be proven unused."""
        active_codes: Set[str] = set(ENGINE_CODES)
        for c in checkers:
            active_codes.update(c.codes)
        out: List[Finding] = []
        for e in entries:
            for line, codes in e.ignores.items():
                if codes is None:
                    if (e.rel, line, None) not in used:
                        out.append(
                            Finding(
                                e.rel,
                                line,
                                "NOS023",
                                "unused suppression: blanket nos-lint ignore "
                                "suppresses no live finding; remove it",
                            )
                        )
                    continue
                for code in sorted(codes):
                    if code == "NOS023":
                        continue  # ignore[NOS023] gates the line below
                    if code not in active_codes:
                        continue
                    if (e.rel, line, code) not in used:
                        out.append(
                            Finding(
                                e.rel,
                                line,
                                "NOS023",
                                f"unused suppression: ignore[{code}] "
                                "suppresses no live finding on this line; "
                                "remove it",
                            )
                        )
        # A NOS023 is itself inline-suppressable via an explicit
        # ignore[NOS023] (one pass, no recursion: an ignore[NOS023] used
        # only here is never re-audited). A *blanket* ignore must not gate
        # it — otherwise every unused blanket would suppress its own audit.
        ignores_by_rel = {e.rel: e.ignores for e in entries}
        kept = [
            f
            for f in out
            if "NOS023"
            not in (ignores_by_rel.get(f.path, {}).get(f.line) or ())
        ]
        return kept
