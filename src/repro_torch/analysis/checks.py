"""AST invariant checks for the CoServe repro tree.

Source of truth: the machine-checked form of docs/architecture.md "Hot
paths and invariants". Five checks, each enforcing one convention the
fast-path equivalence results rest on:

  ``wallclock``   sim semantics never read the wall clock or unseeded RNG,
                  and never iterate a set (hash-order hazard) — every
                  legitimate measurement site is a declared
                  ``registry.ALLOWLIST`` line;
  ``epoch``       every mutation of epoch-guarded state (pool/host
                  membership, byte accounting, in-place group mutation)
                  bumps the paired version counter in the same function —
                  the PR-7 cache-coherence rule, checked against
                  ``registry.EPOCH_CLASSES`` / ``EPOCH_FIELDS``;
  ``tracer``      every ``.emit(`` on a tracer (and every call to a
                  registered trace helper) is dominated by an
                  ``if tracer.enabled:`` / ``if tracer.full:`` guard, and
                  literal event kinds come from ``EVENT_KINDS``;
  ``frozenspec``  no attribute assignment on ``repro_torch.api.spec`` dataclass
                  instances outside ``__post_init__`` /
                  ``dataclasses.replace``, and ``object.__setattr__`` only
                  inside ``__post_init__``;
  ``docstring``   ``fleet/*``, ``memory/*``, ``serve/*``, ``obs/*`` module
                  docstrings carry their latency-number-ownership
                  ("Source of truth") line (PR-4 convention).

Checks are purely syntactic (``ast``), per-file, dependency-free. Scope is
derived from the dotted module path, so fixture trees that mirror
``src/repro_torch/...`` are checked with the real registries.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import registry
from repro_torch.obs.tracer import EVENT_KINDS

# packages whose modules are sim semantics (wallclock / tracer / epoch scope)
SIM_SCOPE = ("repro_torch.core", "repro_torch.memory", "repro_torch.fleet", "repro_torch.serve",
             "repro_torch.api", "repro_torch.obs", "repro_torch.launch", "repro_torch.analysis")

# module docstrings here must declare latency-number ownership (PR 4)
DOCSTRING_SCOPE = ("repro_torch.fleet", "repro_torch.memory", "repro_torch.serve", "repro_torch.obs")
DOCSTRING_TOKENS = ("source of truth", "source-of-truth")

WALLCLOCK_TIME_FUNCS = ("time", "perf_counter", "perf_counter_ns",
                        "monotonic", "monotonic_ns", "process_time",
                        "process_time_ns", "time_ns", "clock")
WALLCLOCK_DATETIME_FUNCS = ("now", "utcnow", "today")
UNSEEDED_RNG_CLASSES = ("Random", "RandomState", "default_rng", "Generator")
FORBIDDEN_CALLS = {("os", "urandom"): "os.urandom is nondeterministic",
                   ("uuid", "uuid1"): "uuid1 reads clock + MAC",
                   ("uuid", "uuid4"): "uuid4 is nondeterministic"}


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    check: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Warning_:
    """Non-fatal finding (stale registry entry); fatal under --strict."""
    check: str
    message: str

    def render(self) -> str:
        return f"warning: [{self.check}] {self.message}"


@dataclasses.dataclass
class Report:
    violations: List[Violation] = dataclasses.field(default_factory=list)
    warnings: List[Warning_] = dataclasses.field(default_factory=list)
    files: int = 0

    def ok(self, strict: bool = False) -> bool:
        return not self.violations and not (strict and self.warnings)


# --------------------------------------------------------------------------- #
# path / AST plumbing
# --------------------------------------------------------------------------- #

def module_name(path: str) -> str:
    """Dotted module for a file path: everything from the last ``repro_torch``
    path component on (``.../src/repro_torch/core/executor.py`` ->
    ``repro_torch.core.executor``). Files outside a ``repro_torch`` tree get ""
    (unscoped: only universal checks apply)."""
    parts = os.path.normpath(path).split(os.sep)
    if "repro_torch" not in parts:
        return ""
    i = len(parts) - 1 - parts[::-1].index("repro_torch")
    mod_parts = parts[i:]
    mod_parts[-1] = mod_parts[-1][:-3] if mod_parts[-1].endswith(".py") \
        else mod_parts[-1]
    if mod_parts[-1] == "__init__":
        mod_parts = mod_parts[:-1]
    return ".".join(mod_parts)


def iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs.sort()
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


class _Scope:
    """Per-file context: qualnames, parents, import aliases."""

    def __init__(self, tree: ast.Module):
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.qualname: Dict[ast.AST, str] = {}
        self.time_aliases: Set[str] = set()       # import time as _t
        self.datetime_names: Set[str] = set()     # datetime / imported class
        self.random_aliases: Set[str] = set()     # import random [as r]
        self.nprandom_bases: Set[str] = set()     # np / numpy aliases
        self.from_time: Set[str] = set()          # from time import perf_counter
        stack: List[str] = []

        def visit(node: ast.AST, parent: Optional[ast.AST]):
            if parent is not None:
                self.parents[node] = parent
            is_def = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                       ast.ClassDef))
            if is_def:
                stack.append(node.name)
                self.qualname[node] = ".".join(stack)
            for child in ast.iter_child_nodes(node):
                visit(child, node)
            if is_def:
                stack.pop()

        visit(tree, None)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name
                    if a.name == "time":
                        self.time_aliases.add(name)
                    elif a.name == "datetime":
                        self.datetime_names.add(name)
                    elif a.name == "random":
                        self.random_aliases.add(name)
                    elif a.name == "numpy":
                        self.nprandom_bases.add(name)
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    name = a.asname or a.name
                    if node.module == "time":
                        self.from_time.add(name)
                    elif node.module == "datetime":
                        self.datetime_names.add(name)
                    elif node.module == "numpy" and a.name == "random":
                        self.nprandom_bases.add("")  # `from numpy import random`
                        self.random_aliases.add(name)

    def enclosing_qualname(self, node: ast.AST) -> str:
        """Qualname of the innermost def/class containing ``node``
        ("" at module level)."""
        cur = self.parents.get(node)
        while cur is not None:
            if cur in self.qualname:
                return self.qualname[cur]
            cur = self.parents.get(cur)
        return ""

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


def _attr_path(node: ast.AST) -> str:
    """Dotted source path of a Name/Attribute chain ("" if not a chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _exempt(check: str, module: str, qualname: str,
            matched: Set[Tuple[str, str, str]]) -> bool:
    for e in registry.exemptions_for(check):
        if e.module != module:
            continue
        if e.qualname == "" or qualname == e.qualname \
                or qualname.startswith(e.qualname + "."):
            matched.add((e.check, e.module, e.qualname))
            return True
    return False


# --------------------------------------------------------------------------- #
# check 1: determinism (wall clock / unseeded RNG / set iteration)
# --------------------------------------------------------------------------- #

def check_wallclock(path: str, module: str, tree: ast.Module, scope: _Scope,
                    out: List[Violation], matched: Set) -> None:
    if not module.startswith(SIM_SCOPE):
        return

    def flag(node: ast.AST, msg: str):
        qn = scope.enclosing_qualname(node)
        if not _exempt("wallclock", module, qn, matched):
            out.append(Violation(path, node.lineno, "wallclock", msg))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            # direct set iteration: for/comprehension over a set expression
            it = None
            if isinstance(node, (ast.For, ast.AsyncFor)):
                it = node.iter
            elif isinstance(node, ast.comprehension):
                it = node.iter
            if it is not None and _is_set_expr(it):
                out_node = it if hasattr(it, "lineno") else node
                qn = scope.enclosing_qualname(out_node)
                if not _exempt("wallclock", module, qn, matched):
                    out.append(Violation(
                        path, out_node.lineno, "wallclock",
                        "iteration over a set: hash order is not "
                        "deterministic across runs — wrap in sorted(...)"))
            continue
        fn = node.func
        fpath = _attr_path(fn)
        if not fpath:
            continue
        head, _, tail = fpath.partition(".")
        # wall clock: time.time(), _t.perf_counter(), perf_counter() ...
        if head in scope.time_aliases and tail in WALLCLOCK_TIME_FUNCS:
            flag(node, f"wall-clock read {fpath}() in sim-semantics module "
                       "— sim decisions/metrics must use sim time (add an "
                       "ALLOWLIST entry only for measurement-and-report "
                       "sites)")
        elif "." not in fpath and fpath in scope.from_time \
                and fpath in WALLCLOCK_TIME_FUNCS:
            flag(node, f"wall-clock read {fpath}() (from time import ...) "
                       "in sim-semantics module")
        # datetime.now() / datetime.datetime.now()
        elif head in scope.datetime_names \
                and fpath.split(".")[-1] in WALLCLOCK_DATETIME_FUNCS:
            flag(node, f"wall-clock read {fpath}() in sim-semantics module")
        # unseeded RNG constructors: random.Random(), np.random.RandomState()
        elif fpath.split(".")[-1] in UNSEEDED_RNG_CLASSES \
                and not node.args and not node.keywords \
                and (head in scope.random_aliases
                     or (head in scope.nprandom_bases
                         and ".random." in f".{fpath}.")
                     or fpath.startswith("random.")):
            flag(node, f"unseeded RNG {fpath}() — pass an explicit seed so "
                       "runs are reproducible")
        # module-level random.* draws share hidden global state
        elif head in scope.random_aliases and tail and "." not in tail \
                and tail not in UNSEEDED_RNG_CLASSES \
                and tail in ("random", "randint", "randrange", "choice",
                             "choices", "shuffle", "sample", "uniform",
                             "gauss", "expovariate", "betavariate"):
            flag(node, f"module-level {fpath}() uses the hidden global RNG "
                       "— use a seeded random.Random(seed) instance")
        elif (head, tail) in FORBIDDEN_CALLS:
            flag(node, f"{fpath}(): {FORBIDDEN_CALLS[(head, tail)]}")


def _is_set_expr(node: ast.AST) -> bool:
    """Syntactically-certain set expressions: literals, set()/frozenset()
    calls, and &|^- combinations of .keys() views. Membership tests are
    fine; only *iteration* over these is order-hazardous."""
    if isinstance(node, ast.Set):
        return True
    if isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor, ast.Sub)):
        def keysish(n):
            return (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "keys") or _is_set_expr(n)
        return keysish(node.left) or keysish(node.right)
    return False


# --------------------------------------------------------------------------- #
# check 2: epoch discipline
# --------------------------------------------------------------------------- #

def _mutated_fields(fn: ast.AST, bases: Tuple[str, ...],
                    fields: Sequence[str]) -> List[Tuple[str, int]]:
    """(field, line) for every mutation of ``<base>.<field>`` inside ``fn``
    where base is one of ``bases`` ("" = any base). Mutations: assignment,
    augmented assignment, subscript store/del, and mutating container-method
    calls."""
    hits: List[Tuple[str, int]] = []

    def field_of(target: ast.AST) -> Optional[str]:
        # <expr>.field  or  <expr>.field[...]
        if isinstance(target, ast.Subscript):
            target = target.value
        if not isinstance(target, ast.Attribute):
            return None
        if target.attr not in fields:
            # <base>.field[...] appears as Subscript(Attribute(attr=field));
            # <base>.field.method() handled in the Call branch below
            return None
        if bases and ("",) != bases:
            base = _attr_path(target.value)
            if base.split(".")[-1] not in bases and base not in bases:
                return None
        return target.attr

    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                f = field_of(t)
                if f is not None:
                    hits.append((f, node.lineno))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                f = field_of(t)
                if f is not None:
                    hits.append((f, node.lineno))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in registry._CONTAINER_MUTATORS:
            f = field_of(node.func.value)
            if f is not None:
                hits.append((f, node.lineno))
    return hits


def _has_bump(fn: ast.AST, bump_attrs: Sequence[str],
              bump_funcs: Sequence[str] = (),
              aug_names: Sequence[str] = ()) -> bool:
    """Whether ``fn`` contains a bump: a call whose attribute path ends in
    one of ``bump_attrs`` (``self.epoch.bump()``, ``pool.epoch.bump()``), a
    bare call to one of ``bump_funcs`` (``bump_queue(q)``), or an augmented
    ``+= 1`` on an attribute named in ``aug_names`` (``self.version += 1``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            p = _attr_path(node.func)
            if any(p == b or p.endswith("." + b) for b in bump_attrs):
                return True
            if isinstance(node.func, ast.Name) and node.func.id in bump_funcs:
                return True
        elif isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add):
            if isinstance(node.target, ast.Attribute) \
                    and node.target.attr in aug_names:
                return True
    return False


def check_epoch(path: str, module: str, tree: ast.Module, scope: _Scope,
                out: List[Violation], matched: Set,
                seen_classes: Set[Tuple[str, str]]) -> None:
    if not module.startswith(SIM_SCOPE):
        return
    # part A: the registered classes' own mutators
    reg_here = {ec.cls: ec for ec in registry.EPOCH_CLASSES
                if ec.module == module}
    class_defs: Dict[str, ast.ClassDef] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            class_defs[node.name] = node
    for cls_name, ec in reg_here.items():
        cdef = class_defs.get(cls_name)
        if cdef is None:
            continue            # stale-registry warning handled by caller
        seen_classes.add((ec.module, ec.cls))
        for item in cdef.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in ec.exempt:
                continue
            mutations = _mutated_fields(item, ("self",), ec.fields)
            for node in ast.walk(item):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ec.super_mutators \
                        and isinstance(node.func.value, ast.Call) \
                        and _attr_path(node.func.value.func) == "super":
                    mutations.append((node.func.attr, node.lineno))
            if mutations and not _has_bump(
                    item, ec.bump_attrs, aug_names=ec.bump_attrs):
                f, line = mutations[0]
                out.append(Violation(
                    path, line, "epoch",
                    f"{ec.cls}.{item.name} mutates epoch-guarded state "
                    f"({f}) without {ec.bump} — epoch-validated caches "
                    "(_holders_cache, _work_cache) would serve stale "
                    "values; bump, or declare an exemption with a reason"))
    # part B: cross-module mutations of registered field names
    owning = set(reg_here)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        encl = scope.enclosing_qualname(node)
        cls_of = encl.split(".")[0] if encl else ""
        if node.name in ("__init__",) or cls_of in owning \
                or node.name in {c.cls for c in registry.EPOCH_CLASSES}:
            continue
        # skip methods of registered classes (part A covered them)
        parent = scope.parents.get(node)
        if isinstance(parent, ast.ClassDef) and parent.name in owning:
            continue
        mutations = _mutated_fields(node, ("",),
                                    tuple(registry.EPOCH_FIELDS))
        # only direct statements of THIS function: drop hits inside nested
        # defs (they are walked as their own functions)
        nested: Set[int] = set()
        for sub in ast.walk(node):
            if sub is not node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for s2 in ast.walk(sub):
                    if hasattr(s2, "lineno"):
                        nested.add(s2.lineno)
        mutations = [(f, ln) for f, ln in mutations if ln not in nested]
        if not mutations:
            continue
        qn = scope.qualname.get(node, node.name)
        if _exempt("epoch", module, qn, matched):
            continue
        if _has_bump(node, registry.EPOCH_BUMP_CALLS,
                     registry.EPOCH_BUMP_FUNCS,
                     aug_names=("version", "n")):
            continue
        f, line = mutations[0]
        out.append(Violation(
            path, line, "epoch",
            f"{qn} mutates epoch-guarded state ({f}: "
            f"{registry.EPOCH_FIELDS[f]}) with no epoch/version bump in "
            "the same function — pair it with .epoch.bump() / "
            "bump_queue(...), or declare an ALLOWLIST exemption"))


# --------------------------------------------------------------------------- #
# check 3: tracer guards + event kinds
# --------------------------------------------------------------------------- #

def _is_tracerish(expr: ast.AST) -> bool:
    p = _attr_path(expr)
    last = p.split(".")[-1] if p else ""
    return last in ("tracer", "_trace") or p == "tracer"


def _guard_names(fn: Optional[ast.AST]) -> Set[str]:
    """Local names assigned from a ``...enabled`` / ``...full`` read
    (``traced = self.tracer.enabled``)."""
    names: Set[str] = set()
    if fn is None:
        return names
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr in ("enabled", "full"):
            names.add(node.targets[0].id)
    return names


def _test_guards(test: ast.AST, guard_names: Set[str]) -> bool:
    """Whether an ``if`` test (or any and-ed component) is a tracer guard."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_test_guards(v, guard_names) for v in test.values)
    if isinstance(test, ast.Attribute) and test.attr in ("enabled", "full"):
        return True
    if isinstance(test, ast.Name) and test.id in guard_names:
        return True
    return False


def _guarded(node: ast.AST, scope: _Scope, guard_names: Set[str]) -> bool:
    cur = scope.parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        if isinstance(cur, ast.If) and _test_guards(cur.test, guard_names):
            return True
        cur = scope.parents.get(cur)
    return False


def check_tracer(path: str, module: str, tree: ast.Module, scope: _Scope,
                 out: List[Violation], matched_helpers: Set) -> None:
    if not module.startswith(SIM_SCOPE) or module == "repro_torch.obs.tracer":
        return
    helper_names = {qual.split(".")[-1]: (mod, qual)
                    for (mod, qual) in registry.TRACE_HELPERS}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        is_emit = attr == "emit" and _is_tracerish(node.func.value)
        helper_key = helper_names.get(attr)
        is_helper_call = (helper_key is not None
                          and helper_key[0] == module
                          and attr != "emit")
        if not is_emit and not is_helper_call:
            continue
        fn = scope.enclosing_function(node)
        qn = scope.enclosing_qualname(node)
        if is_emit:
            # inside a registered helper, the internal emit is exempt (the
            # guard lives at the call sites, which are checked below)
            if (module, qn) in registry.TRACE_HELPERS:
                matched_helpers.add((module, qn))
            elif not _guarded(node, scope, _guard_names(fn)):
                out.append(Violation(
                    path, node.lineno, "tracer",
                    f"unguarded tracer.emit in {qn or '<module>'} — "
                    "hot-path emits must sit under `if tracer.enabled:` "
                    "or `if tracer.full:` (NULL_TRACER still pays argument "
                    "construction without the guard)"))
            # literal event kinds must be registered
            kind = node.args[1] if len(node.args) > 1 else None
            if isinstance(kind, ast.Constant) and isinstance(kind.value, str) \
                    and kind.value not in EVENT_KINDS:
                out.append(Violation(
                    path, kind.lineno, "tracer",
                    f"event kind {kind.value!r} not in EVENT_KINDS "
                    f"{EVENT_KINDS} — trace consumers (export, timeline, "
                    "trace_report --strict) reject unknown kinds"))
        else:
            # a call to a registered unguarded helper needs the same guard
            if qn == helper_key[1]:
                continue       # the helper calling itself
            if not _guarded(node, scope, _guard_names(fn)):
                out.append(Violation(
                    path, node.lineno, "tracer",
                    f"call to trace helper {attr}() in "
                    f"{qn or '<module>'} without an enabled/full guard — "
                    f"{helper_key[1]} emits unconditionally by design "
                    "(registered in TRACE_HELPERS); its call sites carry "
                    "the guard"))


# --------------------------------------------------------------------------- #
# check 4: frozen spec discipline
# --------------------------------------------------------------------------- #

_SPEC_CLASSES_CACHE: Optional[Set[str]] = None


def spec_class_names() -> Set[str]:
    """Frozen-dataclass class names parsed from ``repro/api/spec.py``'s AST
    (no import needed — works on fixture trees too)."""
    global _SPEC_CLASSES_CACHE
    if _SPEC_CLASSES_CACHE is not None:
        return _SPEC_CLASSES_CACHE
    import repro_torch.api.spec as spec_mod
    with open(spec_mod.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) \
                    and _attr_path(dec.func).endswith("dataclass") \
                    and any(kw.arg == "frozen"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True
                            for kw in dec.keywords):
                names.add(node.name)
    _SPEC_CLASSES_CACHE = names
    return names


def check_frozenspec(path: str, module: str, tree: ast.Module, scope: _Scope,
                     out: List[Violation]) -> None:
    if not module.startswith("repro_torch."):
        return
    specs = spec_class_names()
    for node in ast.walk(tree):
        # rule (a): object.__setattr__ only inside __post_init__
        if isinstance(node, ast.Call) \
                and _attr_path(node.func) == "object.__setattr__":
            qn = scope.enclosing_qualname(node)
            if not qn.split(".")[-1] == "__post_init__":
                out.append(Violation(
                    path, node.lineno, "frozenspec",
                    "object.__setattr__ outside __post_init__ — frozen "
                    "specs are immutable after validation; use "
                    "dataclasses.replace to derive a new spec"))
        # rule (b): attr assignment on a var bound to a spec constructor
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "__post_init__":
                continue
            spec_vars: Set[str] = set()
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and isinstance(stmt.value, ast.Call):
                    fpath = _attr_path(stmt.value.func)
                    head = fpath.split(".")[0]
                    tail = fpath.split(".")[-1]
                    if head in specs or (tail in ("from_dict", "load")
                                         and head in specs):
                        spec_vars.add(stmt.targets[0].id)
            if not spec_vars:
                continue
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id in spec_vars:
                            out.append(Violation(
                                path, stmt.lineno, "frozenspec",
                                f"attribute assignment on spec instance "
                                f"{t.value.id!r} — specs are frozen; use "
                                "dataclasses.replace"))


# --------------------------------------------------------------------------- #
# check 5: source-of-truth docstrings
# --------------------------------------------------------------------------- #

def check_docstring(path: str, module: str, tree: ast.Module,
                    out: List[Violation]) -> None:
    if not module.startswith(DOCSTRING_SCOPE):
        return
    if os.path.basename(path) == "__init__.py":
        # package __init__ re-exports; the per-concern lines live in modules
        return
    doc = ast.get_docstring(tree) or ""
    if not any(tok in doc.lower() for tok in DOCSTRING_TOKENS):
        out.append(Violation(
            path, 1, "docstring",
            f"module {module} lacks its latency-number-ownership line — "
            "subsystem modules must declare what they are the "
            "'Source of truth' for (docs/architecture.md, PR-4 convention)"))


# --------------------------------------------------------------------------- #
# driver
# --------------------------------------------------------------------------- #

CHECK_NAMES = ("wallclock", "epoch", "tracer", "frozenspec", "docstring")


def run_checks(paths: Sequence[str],
               checks: Sequence[str] = CHECK_NAMES) -> Report:
    report = Report()
    matched_exemptions: Set[Tuple[str, str, str]] = set()
    matched_helpers: Set[Tuple[str, str]] = set()
    seen_epoch_classes: Set[Tuple[str, str]] = set()
    scanned_modules: Set[str] = set()
    for path in iter_py_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
        except SyntaxError as e:
            report.violations.append(Violation(
                path, e.lineno or 1, "parse", f"syntax error: {e.msg}"))
            continue
        report.files += 1
        module = module_name(path)
        if module:
            scanned_modules.add(module)
        scope = _Scope(tree)
        if "wallclock" in checks:
            check_wallclock(path, module, tree, scope, report.violations,
                            matched_exemptions)
        if "epoch" in checks:
            check_epoch(path, module, tree, scope, report.violations,
                        matched_exemptions, seen_epoch_classes)
        if "tracer" in checks:
            check_tracer(path, module, tree, scope, report.violations,
                         matched_helpers)
        if "frozenspec" in checks:
            check_frozenspec(path, module, tree, scope, report.violations)
        if "docstring" in checks:
            check_docstring(path, module, tree, report.violations)
    # stale-registry warnings: entries that matched nothing in a scan that
    # actually covered their module (fixture scans cover a couple of files —
    # don't report the rest of the registry as stale there)
    for e in registry.ALLOWLIST:
        if e.module in scanned_modules \
                and (e.check, e.module, e.qualname) not in matched_exemptions:
            report.warnings.append(Warning_(
                e.check,
                f"stale ALLOWLIST entry ({e.module}, {e.qualname!r}): "
                f"matched nothing — remove it or fix the qualname "
                f"[reason was: {e.reason}]"))
    for ec in registry.EPOCH_CLASSES:
        if ec.module in scanned_modules \
                and (ec.module, ec.cls) not in seen_epoch_classes:
            report.warnings.append(Warning_(
                "epoch",
                f"EPOCH_CLASSES entry {ec.module}.{ec.cls} not found in "
                "the scanned tree — registry is stale"))
    for (mod, qual), reason in registry.TRACE_HELPERS.items():
        if mod in scanned_modules and (mod, qual) not in matched_helpers:
            report.warnings.append(Warning_(
                "tracer",
                f"TRACE_HELPERS entry {mod}.{qual} matched no emit — "
                f"registry is stale [reason was: {reason}]"))
    return report
