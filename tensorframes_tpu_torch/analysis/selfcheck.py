"""Package self-lint: AST rules for hazards ruff has no opinion on.

Run: ``python -m tensorframes_tpu_torch.analysis selfcheck [paths]``
(default: the ``tensorframes_tpu_torch/`` package). Exit 0 when clean; 1
with one ``path:line: TFL### message`` per finding. The reference
package's ``analysis/selfcheck.py``, with the same codes and pragmas; the
TFL codes are in :mod:`.diagnostics`' catalog.

Rules (a pragma on the line silences one finding):

* **TFL001** — a bare ``torch.compile``, ``torch.jit.*`` or
  ``torch.utils.cpp_extension.load``/``load_inline`` outside
  ``kernels/`` (the counterpart of the reference's bare ``jax.jit``):
  compiled code must come from the hand-written kernel library, built
  from content-hashed sources under its lock
  (:mod:`tensorframes_tpu_torch.kernels`); a second compiler path would
  build unhashed, unlocked artifacts per process. Pragma:
  ``# lint: allow-jax-jit``.
* **TFL002** — module-level mutable container mutated from function
  scope without a module-level ``threading.Lock``/``RLock`` (verbs run
  from prefetch worker threads). Pragma: ``# lint: guarded``.
* **TFL003** — get-or-create metrics calls (``counter``/``gauge``/
  ``histogram`` on the default registry) inside a function: instruments
  pre-register at import so expositions always carry the full catalog.
  Pragma: ``# lint: runtime-metric-ok``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Dict, List, Tuple

PKG = Path(__file__).resolve().parent.parent
REPO = PKG.parent

#: Where the package may call a compiler itself: the kernel library.
ALLOW_COMPILE_DIRS = ("tensorframes_tpu_torch/kernels/",)

#: Dotted call targets TFL001 refuses (a prefix ending in "." matches
#: every attribute below it).
BANNED_COMPILE = ("torch.compile", "torch.jit.", "torch.utils.cpp_extension.load")

MUTATORS = {
    "append", "add", "update", "setdefault", "pop", "clear", "extend",
    "insert", "remove", "popitem", "discard",
}

METRIC_FACTORIES = {"counter", "gauge", "histogram"}


def _pragma(lines: List[str], lineno: int, tag: str) -> bool:
    line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
    return f"lint: {tag}" in line


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("dict", "list", "set", "deque", "defaultdict")
    return False


def _creates_lock(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("Lock", "RLock"):
                return True
            if isinstance(f, ast.Name) and f.id in ("Lock", "RLock"):
                return True
    return False


def _import_aliases(tree) -> Dict[str, str]:
    """Local name -> the dotted name it was imported as."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _dotted(node, aliases: Dict[str, str]) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _banned(name: str) -> bool:
    return any(name == b or (b.endswith(".") and name.startswith(b))
               or name.startswith(b + "_") for b in BANNED_COMPILE)


def _compile_findings(tree, rel, lines) -> List[Tuple[int, str, str]]:
    if any(rel.startswith(d) for d in ALLOW_COMPILE_DIRS):
        return []
    aliases = _import_aliases(tree)
    out = []
    targets = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            targets.append((node.lineno, node.func))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            targets.extend((d.lineno, d) for d in node.decorator_list
                           if not isinstance(d, ast.Call))
    for lineno, target in targets:
        name = _dotted(target, aliases)
        if not name or not _banned(name):
            continue
        if _pragma(lines, lineno, "allow-jax-jit"):
            continue
        out.append((
            lineno, "TFL001",
            f"bare {name} in library code: compiled code must come from "
            "the hand-written kernel library (tensorframes_tpu_torch."
            "kernels: content-hashed sources, one build under its lock) — "
            "move it there, or mark the line '# lint: allow-jax-jit' with "
            "a reason",
        ))
    return out


def _mutable_state_findings(tree, rel, lines) -> List[Tuple[int, str, str]]:
    module_containers = {}
    for node in tree.body:
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            target = node.targets[0].id
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target = node.target.id
            value = node.value
        if target is None or not _is_mutable_literal(value):
            continue
        if _pragma(lines, node.lineno, "guarded"):
            continue
        module_containers[target] = node.lineno
    if not module_containers:
        return []
    has_lock = _creates_lock(tree)

    mutated = set()

    class FnVisitor(ast.NodeVisitor):
        def __init__(self):
            self.depth = 0

        def visit_FunctionDef(self, node):
            self.depth += 1
            self.generic_visit(node)
            self.depth -= 1

        visit_AsyncFunctionDef = visit_FunctionDef

        def _name_of(self, v):
            return v.id if isinstance(v, ast.Name) else None

        def visit_Call(self, node):
            if self.depth and isinstance(node.func, ast.Attribute) and \
                    node.func.attr in MUTATORS:
                n = self._name_of(node.func.value)
                if n in module_containers:
                    mutated.add(n)
            self.generic_visit(node)

        def visit_Subscript(self, node):
            if self.depth and isinstance(node.ctx, (ast.Store, ast.Del)):
                n = self._name_of(node.value)
                if n in module_containers:
                    mutated.add(n)
            self.generic_visit(node)

    FnVisitor().visit(tree)
    out = []
    if not has_lock:
        for name in sorted(mutated):
            out.append((
                module_containers[name], "TFL002",
                f"module-level mutable {name!r} is mutated from function "
                "scope but the module creates no threading.Lock/RLock — "
                "guard it (or mark the line '# lint: guarded' with a "
                "single-threaded justification)",
            ))
    return out


def _metric_findings(tree, rel, lines) -> List[Tuple[int, str, str]]:
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("observability.metrics"):
            for a in node.names:
                if a.name in METRIC_FACTORIES:
                    aliases[a.asname or a.name] = a.name
    if not aliases:
        return []
    out = []

    class FnVisitor(ast.NodeVisitor):
        def __init__(self):
            self.depth = 0

        def visit_FunctionDef(self, node):
            self.depth += 1
            self.generic_visit(node)
            self.depth -= 1

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            f = node.func
            bad = False
            if isinstance(f, ast.Name) and f.id in aliases:
                bad = self.depth > 0
            elif isinstance(f, ast.Attribute) and f.attr in METRIC_FACTORIES \
                    and isinstance(f.value, ast.Name) and f.value.id == "REGISTRY":
                bad = self.depth > 0
            if bad and not _pragma(lines, node.lineno, "runtime-metric-ok"):
                out.append((
                    node.lineno, "TFL003",
                    "metrics get-or-create inside a function: instruments "
                    "must pre-register at import so the exposition always "
                    "carries the full catalog (move to module level, pass "
                    "an explicit registry, or mark "
                    "'# lint: runtime-metric-ok')",
                ))
            self.generic_visit(node)

    FnVisitor().visit(tree)
    return out


def lint_file(path: Path) -> List[str]:
    path = Path(path).resolve()
    rel = str(path.relative_to(REPO)) if path.is_relative_to(REPO) else str(path)
    src = path.read_text()
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: TFL000 syntax error: {e.msg}"]
    findings = []
    findings += _compile_findings(tree, rel, lines)
    findings += _mutable_state_findings(tree, rel, lines)
    findings += _metric_findings(tree, rel, lines)
    return [f"{rel}:{ln}: {code} {msg}" for ln, code, msg in sorted(findings)]


def main(argv: List[str]) -> int:
    roots = [Path(a) for a in argv] or [PKG]
    files: List[Path] = []
    for r in roots:
        files.extend(sorted(r.rglob("*.py")) if r.is_dir() else [r])
    all_findings: List[str] = []
    for f in files:
        all_findings.extend(lint_file(f))
    for line in all_findings:
        print(line)
    print(
        f"analysis selfcheck: {len(files)} file(s), "
        f"{len(all_findings)} finding(s)"
    )
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
