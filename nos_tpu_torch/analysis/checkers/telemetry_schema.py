"""Port of `nos_tpu/analysis/checkers/telemetry_schema.py:1` (:1-232). Copied
near verbatim; the imports point at the port, which imports nothing of the
JAX package.

NOS022 — telemetry schema drift across the three metric artifacts.

A metric series in this tree lives in three places at once: the emit site
(`metrics.inc("nos_tpu_decode_steps")` in runtime/ or serving/), the
schema registry (`observability.METRIC_SERIES`), and the operator docs
(`docs/telemetry.md`). Historically nothing tied them together — the
shadow-table sync in decode_server and the fleet gauges each grew names
the docs never heard of, and a typo'd emit name would silently create a
new, never-scraped series. This checker makes the registry the single
source of truth and flags every divergence:

  rule A (emit -> registry): every string literal starting ``nos_tpu_`` in
      runtime/ + serving/ code must be a registered series name, or match
      a registered FAMILY prefix (a spec name ending ``*``). Dynamic
      f-string names (``f"nos_tpu_tenant_cost_{field}"``) must lead with a
      fragment that matches a family. Docstrings are prose and exempt.

  rule B (registry -> report/merge): a spec's `report_field` must be a
      real ServingReport field, and a float-typed one must be listed in
      `telemetry.MERGE_FLOAT_FIELDS` — otherwise fleet aggregation
      silently drops it on the int-summing path.

  rule C (registry -> docs): every registered name (family prefixes
      included) must appear in docs/telemetry.md. Undocumented telemetry
      is unusable telemetry.

The reverse of rule A (registered but never emitted) is deliberately NOT
checked: emission is often conditional (spill tier off, supervisor absent)
and a registry entry for a temporarily-dark series is correct, not drift.

Cross-file by nature: the verdict depends on observability.py,
telemetry.py and the docs file, all declared via `extra_inputs` so the
incremental cache invalidates when any of the three artifacts moves.
Constructor-injectable registry/schema/docs for fixture tests.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Optional, Sequence, Set, Tuple

from nos_tpu_torch.analysis.core import Checker, FileContext, Report

_PREFIX = "nos_tpu_"


class TelemetrySchemaChecker(Checker):
    name = "telemetry-schema"
    codes = ("NOS022",)
    description = "metric emits, the schema registry, and the docs must agree"
    cross_file = True  # verdicts span the registry, the report schema, docs

    def __init__(
        self,
        registry: Optional[Sequence] = None,
        report_fields: Optional[Dict[str, str]] = None,
        merge_float_fields: Optional[Sequence[str]] = None,
        docs_rel: str = "docs/telemetry.md",
        registry_rel: str = "nos_tpu_torch/observability.py",
    ) -> None:
        self._injected = registry is not None
        self._registry = registry
        self._report_fields = report_fields
        self._merge_float_fields = merge_float_fields
        self._docs_rel = docs_rel
        self._registry_rel = registry_rel
        self._root: Optional[str] = None
        self._saw_registry_module = False
        self._active = False
        self._exact: Set[str] = set()
        self._families: Tuple[str, ...] = ()

    def extra_inputs(self) -> Sequence[str]:
        return (self._docs_rel, self._registry_rel, "nos_tpu_torch/telemetry.py")

    # -- schema loading ------------------------------------------------------
    def _specs(self) -> Sequence:
        if self._registry is not None:
            return self._registry
        from nos_tpu_torch import observability

        return observability.METRIC_SERIES

    def _schema(self) -> Tuple[Dict[str, str], Set[str]]:
        """(ServingReport field -> type string, merge float-field names)."""
        if self._report_fields is not None:
            floats = set(self._merge_float_fields or ())
            return dict(self._report_fields), floats
        import dataclasses

        from nos_tpu_torch import telemetry

        fields = {
            f.name: (f.type if isinstance(f.type, str) else getattr(f.type, "__name__", str(f.type)))
            for f in dataclasses.fields(telemetry.ServingReport)
        }
        return fields, set(telemetry.MERGE_FLOAT_FIELDS)

    def _load_names(self) -> None:
        exact: Set[str] = set()
        families = []
        for spec in self._specs():
            if spec.name.endswith("*"):
                families.append(spec.name[:-1])
            else:
                exact.add(spec.name)
        self._exact = exact
        self._families = tuple(families)

    # -- rule A: emit sites --------------------------------------------------
    def begin_file(self, ctx: FileContext) -> None:
        self._root = ctx.root
        if ctx.rel == self._registry_rel:
            self._saw_registry_module = True
        segs = ctx.segments[:-1]
        self._active = "runtime" in segs or "serving" in segs
        if self._active and not self._exact and not self._families:
            self._load_names()

    def visit(self, ctx: FileContext, node: ast.AST, report: Report) -> None:
        if not self._active:
            return
        if isinstance(node, ast.JoinedStr):
            self._check_dynamic(ctx, node, report)
            return
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            return
        if not node.value.startswith(_PREFIX):
            return
        if ctx.is_docstring(node):
            return
        if isinstance(ctx.parent(), (ast.JoinedStr, ast.FormattedValue)):
            return  # fragment of a dynamic name; judged at the JoinedStr
        name = node.value
        if name in self._exact:
            return
        if any(name.startswith(p) for p in self._families):
            return
        report.add(
            ctx.rel,
            node.lineno,
            "NOS022",
            f"telemetry drift: metric name '{name}' is not registered in "
            "observability.METRIC_SERIES; register it (and document it in "
            "docs/telemetry.md) or fix the typo",
        )

    def _check_dynamic(
        self, ctx: FileContext, node: ast.JoinedStr, report: Report
    ) -> None:
        head = node.values[0] if node.values else None
        if not (
            isinstance(head, ast.Constant)
            and isinstance(head.value, str)
            and head.value.startswith(_PREFIX)
        ):
            return
        frag = head.value
        if any(frag.startswith(p) or p.startswith(frag) for p in self._families):
            return
        report.add(
            ctx.rel,
            node.lineno,
            "NOS022",
            f"telemetry drift: dynamic metric name 'f\"{frag}...\"' matches "
            "no registered family in observability.METRIC_SERIES; register "
            "a family spec (name ending '*') for it",
        )

    # -- rules B + C: registry vs report schema vs docs ----------------------
    def finish(self, report: Report) -> None:
        if not self._injected and not self._saw_registry_module:
            # Linting a subtree that doesn't include the registry module:
            # the schema-wide rules belong to whole-tree runs only.
            return
        self._load_names()
        fields, merge_floats = self._schema()
        for spec in self._specs():
            rf = getattr(spec, "report_field", None)
            if rf is None:
                continue
            if rf not in fields:
                report.add(
                    self._registry_rel,
                    1,
                    "NOS022",
                    f"telemetry drift: METRIC_SERIES entry '{spec.name}' "
                    f"names report_field '{rf}', which ServingReport does "
                    "not carry",
                )
            elif fields[rf] == "float" and rf not in merge_floats:
                report.add(
                    self._registry_rel,
                    1,
                    "NOS022",
                    f"telemetry drift: float report_field '{rf}' (metric "
                    f"'{spec.name}') is missing from telemetry."
                    "MERGE_FLOAT_FIELDS — fleet merge would int-sum it",
                )
        docs = self._read_docs()
        if docs is None:
            report.add(
                self._docs_rel,
                1,
                "NOS022",
                f"telemetry drift: docs file '{self._docs_rel}' is missing "
                "but METRIC_SERIES registers metrics that need documenting",
            )
            return
        for spec in self._specs():
            name = spec.name[:-1] if spec.name.endswith("*") else spec.name
            if name not in docs:
                report.add(
                    self._docs_rel,
                    1,
                    "NOS022",
                    f"telemetry drift: registered metric '{spec.name}' is "
                    f"not documented in {self._docs_rel}",
                )

    def _read_docs(self) -> Optional[str]:
        path = self._docs_rel
        if not os.path.isabs(path):
            if self._root is None:
                return None
            path = os.path.join(self._root, path)
        try:
            with open(path, "r", encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None
