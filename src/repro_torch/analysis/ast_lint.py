"""AST lint: custom Python source rules over ``src/repro_torch``.

A copy of ``repro/analysis/ast_lint.py``: the same three rules, ids and
suppression comments, over the port's tree by default. One addition, the
port's counterpart of ``jax.config``: ``ast-import-env-mutation`` also
flags a module-level assignment to ``torch.backends.<...>`` (TF32, cuDNN
and the like) and a module-level ``torch.set_<...>(...)`` call
(``set_default_dtype``, ``set_float32_matmul_precision``,
``set_num_threads``, ...), which change the process for every importer.

Rules (ids are what ``# lint: disable=...`` must name):

  ast-prng-reuse
      The same PRNG key expression is consumed by two random-consuming
      calls in one function scope without an intervening reassignment
      (``split``/``fold_in`` are key *derivers*, not consumers). This is
      the exact bug class once fixed in ``CrossDeviceSim.step``: the
      message-level attack shared the aggregator's key, correlating
      attacker randomness with the defense's resampling permutation.
      Consumers are ``jax.random.<sampler>(key, ...)`` calls and ANY call
      taking a ``key=`` / ``rng=`` keyword argument.

  ast-import-env-mutation
      Module-import-time mutation of process/backend state:
      ``os.environ[...] = ...`` (or ``.update``/``.setdefault``/``.pop``),
      ``os.putenv``, ``jax.config.update`` or ``jax.config.<attr> = ...``,
      ``torch.backends.<...> = ...`` or ``torch.set_<...>(...)``
      at module level (the ``launch/dryrun.py`` bug class — forcing 512
      host devices on whoever imports the module). Statements under an
      ``if __name__ == "__main__":`` guard are exempt, as is anything
      inside a function body.

  ast-mutable-default
      Mutable default argument (``def f(x, acc=[])``).

Suppression: append ``# lint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the flagged line.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.findings import ERROR, Finding

RULES = ("ast-prng-reuse", "ast-import-env-mutation", "ast-mutable-default")

# jax.random.* functions that DERIVE keys rather than consuming randomness.
_KEY_DERIVERS = frozenset(
    {"split", "fold_in", "PRNGKey", "key", "wrap_key_data", "key_data",
     "clone", "key_impl"})
# keyword names treated as "this call consumes this PRNG key"
_KEY_KWARGS = frozenset({"key", "rng", "rng_key", "prng_key"})

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w\-,\s]+)")


# --------------------------------------------------------------- helpers
def _dotted(node: ast.AST) -> Optional[str]:
    """'os.environ' for Attribute(Name('os'), 'environ'); None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _key_expr_id(node: ast.AST) -> Optional[Tuple]:
    """Stable identity for a trackable key expression (Name, Name[int],
    dotted attribute); None for calls/constants (untrackable)."""
    if isinstance(node, ast.Name):
        return ("name", node.id)
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        idx = node.slice
        if isinstance(idx, ast.Constant):
            return ("sub", node.value.id, idx.value)
        return None
    dotted = _dotted(node)
    if dotted is not None:
        return ("attr", dotted)
    return None


def _base_name(expr_id: Tuple) -> str:
    if expr_id[0] == "attr":
        return expr_id[1].split(".")[0]
    return expr_id[1]


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _calls_in(node: ast.AST) -> Iterable[ast.Call]:
    """Call nodes in source order, NOT descending into nested scopes."""
    out: List[ast.Call] = []

    def rec(n: ast.AST) -> None:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _SCOPE_NODES + (ast.ClassDef,)):
                continue
            if isinstance(child, ast.Call):
                out.append(child)
            rec(child)

    rec(node)
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out


def _assigned_names(stmt: ast.stmt) -> List[str]:
    """Base names (re)bound by this statement."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items if i.optional_vars]
    names: List[str] = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                names.append(n.id)
    return names


# ----------------------------------------------------------- PRNG reuse
class _PrngScope:
    """Linear statement walk of one function/module scope."""

    def __init__(self, filename: str):
        self.filename = filename
        self.findings: List[Finding] = []
        # expr id -> (first consumer line, call description)
        self.uses: Dict[Tuple, Tuple[int, str]] = {}

    def _consumers(self, call: ast.Call) -> List[Tuple[ast.AST, str]]:
        """(key expression node, call description) consumed by this call."""
        out: List[Tuple[ast.AST, str]] = []
        dotted = _dotted(call.func) or ""
        if dotted.startswith("jax.random.") or dotted.startswith("jrandom."):
            fn = dotted.rsplit(".", 1)[1]
            if fn in _KEY_DERIVERS:
                return []
            if call.args:
                out.append((call.args[0], dotted))
            for kw in call.keywords:
                if kw.arg in _KEY_KWARGS:
                    out.append((kw.value, dotted))
            return out
        for kw in call.keywords:
            if kw.arg in _KEY_KWARGS:
                out.append((kw.value, dotted or "<call>"))
        return out

    def _scan_calls(self, stmt: ast.stmt) -> None:
        for call in _calls_in(stmt):
            for key_node, desc in self._consumers(call):
                expr_id = _key_expr_id(key_node)
                if expr_id is None:
                    continue
                prev = self.uses.get(expr_id)
                if prev is not None:
                    first_line, first_desc = prev
                    self.findings.append(Finding(
                        rule="ast-prng-reuse", severity=ERROR,
                        target=self.filename,
                        location=f"{self.filename}:{key_node.lineno}",
                        message=(
                            f"PRNG key {ast.unparse(key_node)!r} consumed by "
                            f"{desc} was already consumed by {first_desc} at "
                            f"line {first_line} with no split/reassignment "
                            f"in between"),
                    ))
                else:
                    self.uses[expr_id] = (key_node.lineno, desc)

    def _reassign(self, stmt: ast.stmt) -> None:
        names = set(_assigned_names(stmt))
        if names:
            self.uses = {k: v for k, v in self.uses.items()
                         if _base_name(k) not in names}

    def walk(self, body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, _SCOPE_NODES + (ast.ClassDef,)):
                continue  # nested scopes are scanned separately
            if isinstance(stmt, (ast.If, ast.Try)):
                self._scan_calls_shallow(stmt)
                entry = dict(self.uses)
                branches = []
                if isinstance(stmt, ast.If):
                    branches = [stmt.body, stmt.orelse]
                else:
                    branches = [stmt.body, stmt.orelse, stmt.finalbody]
                    branches += [h.body for h in stmt.handlers]
                for branch in branches:
                    self.uses = dict(entry)
                    self.walk(branch)
                # only one branch executes: don't carry branch-local uses
                # forward (conservative — avoids if/else false positives).
                self.uses = entry
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While,
                                 ast.With, ast.AsyncWith)):
                self._scan_calls_shallow(stmt)
                self._reassign(stmt)
                self.walk(stmt.body)
                self.walk(getattr(stmt, "orelse", []) or [])
                continue
            self._scan_calls(stmt)
            self._reassign(stmt)

    def _scan_calls_shallow(self, stmt: ast.stmt) -> None:
        """Scan only the header expression of a compound statement (the
        test / iterable / context managers), not its body."""
        headers: List[ast.AST] = []
        if isinstance(stmt, ast.If) or isinstance(stmt, ast.While):
            headers = [stmt.test]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            headers = [stmt.iter]
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            headers = [i.context_expr for i in stmt.items]
        for h in headers:
            fake = ast.Expr(value=h)
            ast.copy_location(fake, h)
            self._scan_calls(fake)


def _prng_reuse(tree: ast.Module, filename: str) -> List[Finding]:
    findings: List[Finding] = []
    # module scope
    scope = _PrngScope(filename)
    scope.walk(tree.body)
    findings.extend(scope.findings)
    # every function scope, wherever nested
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fscope = _PrngScope(filename)
            fscope.walk(node.body)
            findings.extend(fscope.findings)
    return findings


# ------------------------------------------------- import-time env mutation
_ENV_MUTATORS = frozenset({"update", "setdefault", "pop", "popitem", "clear"})


def _is_main_guard(stmt: ast.stmt) -> bool:
    if not isinstance(stmt, ast.If):
        return False
    t = stmt.test
    return (isinstance(t, ast.Compare)
            and isinstance(t.left, ast.Name) and t.left.id == "__name__")


def _walk_no_scope(node: ast.AST) -> Iterable[ast.AST]:
    """node + descendants, never descending into function/lambda bodies."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, _SCOPE_NODES):
                stack.append(c)


def _env_mutation(tree: ast.Module, filename: str) -> List[Finding]:
    findings: List[Finding] = []

    def flag(node: ast.AST, what: str) -> None:
        findings.append(Finding(
            rule="ast-import-env-mutation", severity=ERROR, target=filename,
            location=f"{filename}:{node.lineno}",
            message=(f"{what} at module import time — move it behind an "
                     f"explicit activate()/main() guard (the dryrun.py bug "
                     f"class: import order silently decides process state)"),
        ))

    def check_tree(root: ast.AST) -> None:
        for node in _walk_no_scope(root):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (node.targets if isinstance(node, (ast.Assign,
                                                             ast.Delete))
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) and \
                            _dotted(t.value) == "os.environ":
                        flag(node, "os.environ[...] mutation")
                    elif isinstance(t, ast.Attribute) and \
                            (_dotted(t) or "").startswith(("jax.config.",
                                                           "torch.backends.")):
                        flag(node, f"assignment to {_dotted(t)}")
            elif isinstance(node, ast.Call):
                dotted = _dotted(node.func) or ""
                if dotted.startswith("os.environ.") and \
                        dotted.rsplit(".", 1)[1] in _ENV_MUTATORS:
                    flag(node, f"{dotted}() mutation")
                elif dotted == "os.putenv":
                    flag(node, "os.putenv() mutation")
                elif dotted.startswith("jax.config.") or \
                        dotted.startswith("torch.set_"):
                    flag(node, f"{dotted}() call")

    def _headers(stmt: ast.stmt) -> List[ast.AST]:
        if isinstance(stmt, (ast.If, ast.While)):
            return [stmt.test]
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return [stmt.iter]
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return [i.context_expr for i in stmt.items]
        if isinstance(stmt, ast.ClassDef):
            return list(stmt.bases) + list(stmt.decorator_list)
        return []

    def visit_body(body: Iterable[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # function bodies run at call time, not at import
            if _is_main_guard(stmt):
                continue
            if isinstance(stmt, (ast.If, ast.Try, ast.For, ast.AsyncFor,
                                 ast.While, ast.With, ast.AsyncWith,
                                 ast.ClassDef)):
                for h in _headers(stmt):
                    check_tree(h)
                for sub in (getattr(stmt, "body", []),
                            getattr(stmt, "orelse", []),
                            getattr(stmt, "finalbody", []),
                            *[h.body for h in getattr(stmt, "handlers", [])]):
                    visit_body(sub)
            else:
                check_tree(stmt)

    visit_body(tree.body)
    return findings


# ------------------------------------------------------- mutable defaults
_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                     ast.SetComp)
_MUTABLE_CTORS = frozenset({"list", "dict", "set", "defaultdict"})


def _mutable_defaults(tree: ast.Module, filename: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            bad = isinstance(d, _MUTABLE_LITERALS) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in _MUTABLE_CTORS)
            if bad:
                findings.append(Finding(
                    rule="ast-mutable-default", severity=ERROR,
                    target=filename,
                    location=f"{filename}:{d.lineno}",
                    message=(f"mutable default argument "
                             f"{ast.unparse(d)!r} in {node.name}() is shared "
                             f"across calls — default to None instead"),
                ))
    return findings


# ------------------------------------------------------------ entry points
def _suppressed_rules(source_line: str) -> frozenset:
    m = _SUPPRESS_RE.search(source_line)
    if not m:
        return frozenset()
    return frozenset(r.strip() for r in m.group(1).split(","))


def lint_source(source: str, filename: str = "<string>") -> List[Finding]:
    """All AST rules over one source string."""
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as e:
        return [Finding(rule="ast-syntax-error", severity=ERROR,
                        target=filename, location=f"{filename}:{e.lineno}",
                        message=str(e))]
    findings = (_prng_reuse(tree, filename)
                + _env_mutation(tree, filename)
                + _mutable_defaults(tree, filename))
    lines = source.splitlines()
    kept = []
    for f in findings:
        try:
            line_no = int(f.location.rsplit(":", 1)[1])
            suppressed = _suppressed_rules(lines[line_no - 1])
        except (IndexError, ValueError):
            suppressed = frozenset()
        if f.rule in suppressed or "all" in suppressed:
            continue
        kept.append(f)
    kept.sort(key=lambda f: f.location)
    return kept


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    """All AST rules over every ``*.py`` file under the given paths."""
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                files.extend(os.path.join(dirpath, fn)
                             for fn in sorted(filenames)
                             if fn.endswith(".py"))
        for path in files:
            with open(path, "r", encoding="utf-8") as fh:
                findings.extend(lint_source(fh.read(), filename=path))
    return findings
