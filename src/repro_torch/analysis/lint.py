"""The port's AST linter: the port's rules as machine-checked invariants.

``python -m repro_torch.lint [paths]`` parses every ``.py`` file under the
given paths (default ``src/repro_torch`` and ``chip_smoke.py``) and
reports ``file:line rule message`` findings, exiting 1 when any survive
(0 when clean, 2 on a usage error).  Rules live in an open registry,
:func:`register_rule`, so a plugin (or a test) adds a rule without
touching this module.  The counterpart of the JAX package's linter.

Builtin rules:

  * ``jax-import``: any import of ``jax``, ``jaxlib``, ``flax`` or the JAX
    package ``repro`` (``repro.*``), at any depth of a module (inside a
    function too): the port imports neither.
  * ``kernel-fallback``: a ``try`` whose body builds or launches a kernel
    (``_build.build``, a kernel module's ``launch*``, a library entry
    ``lib.fn(...)(...)``) and whose handler does anything but re-raise: a
    CUDA tensor launches the kernel or raises, it never falls back.
  * ``import-time-build``: a module-level call that compiles, loads or
    touches the card (``_build.build``, ``subprocess``, ``import triton``,
    ``ctypes.CDLL``, ``torch.cuda.*``, ``device="cuda"``, ``.cuda()``):
    kernels are built at first use, so every module imports anywhere.
  * ``host-sync-in-hot-path`` (``host-sync-in-jit``'s counterpart):
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()`` /
    ``int()`` / ``bool()`` of a tensor argument, or
    ``torch.cuda.synchronize()``, inside a ``torch.library.custom_op``
    body or a function the registration names as hot (the decode steps,
    ``price_grid_fused``, ``price_topk_chunk``, the train step).
  * ``compile-in-loop`` (``jit-in-loop``'s counterpart): ``torch.compile``,
    ``core.graph.capture``, ``make_fx`` or a ``torch.cuda.CUDAGraph()``
    built inside a loop body.
  * ``default-dtype-leak`` (``x64-leak``'s counterpart):
    ``torch.set_default_dtype`` or a write to ``torch.backends.*
    .allow_tf32`` outside a function that restores it in a ``finally``.
  * ``unknown-noqa``: a pragma naming no registered rule.

The reference's ``donation-misuse`` has no AST counterpart: PyTorch
donates nothing, and an in-place update that does not happen is what the
IR tier's ``inplace-dead`` checks on captured steps.  Its
``compat-drift`` has none either: the port's compat policy is
``jax-import``.

Suppression: ``# repro_torch: noqa`` (all rules) or ``# repro_torch:
noqa[rule-a,rule-b]`` on the offending line, with a reason after it.  The
JAX package's linter lints every file under ``src/`` and reads ``# repro:
noqa``, so the port's pragma has a name of its own.  Rules may carry path
allowlists (``register_rule(..., allow_paths=(...))``, fnmatch patterns
against the reported path) and settings the check receives as keyword
arguments (``host-sync-in-hot-path``'s ``hot`` functions).

Everything here is stdlib-only: the linter runs without torch.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import fnmatch
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator

# --------------------------------------------------------------------------
# Findings, file context, rule registry
# --------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Finding:
    """One lint violation, printed as ``path:line rule message``."""

    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


@dataclass
class FileContext:
    """Everything a rule needs about one parsed file."""

    path: Path
    rel: str                     # the path as reported (posix separators)
    tree: ast.Module
    lines: list
    _parents: dict = field(default_factory=dict, repr=False)

    @property
    def parents(self) -> dict:
        """Lazily-built ``{child node: parent node}`` map over the tree."""
        if not self._parents:
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents


#: A rule check: ``fn(ctx, **settings) -> iterable of (node_or_lineno,
#: message)``.
RuleCheck = Callable[..., Iterable]


@dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    check: RuleCheck
    allow_paths: tuple = ()
    settings: tuple = ()         # (key, value) pairs passed to check

    def applies_to(self, rel: str) -> bool:
        return not any(fnmatch.fnmatch(rel, pat) for pat in self.allow_paths)

    def run(self, ctx: FileContext) -> Iterable:
        return self.check(ctx, **dict(self.settings))


_RULES: dict = {}


def register_rule(name: str, *, allow_paths=(), overwrite: bool = False,
                  **settings):
    """Register a lint rule under ``name`` (decorator).

    The decorated function receives a :class:`FileContext` (and
    ``settings`` as keyword arguments) and yields ``(node_or_lineno,
    message)`` pairs; the engine stamps them into :class:`Finding`\\ s.
    ``allow_paths`` are fnmatch patterns (matched against the reported
    path) for which the rule is skipped entirely.  Registering an existing
    name raises unless ``overwrite=True``.
    """
    def deco(fn: RuleCheck) -> RuleCheck:
        if not overwrite and name in _RULES:
            raise ValueError(f"lint rule {name!r} is already registered "
                             "(pass overwrite=True to replace it)")
        doc = (fn.__doc__ or "").strip().splitlines()
        _RULES[name] = Rule(name, doc[0] if doc else "", fn,
                            tuple(allow_paths), tuple(settings.items()))
        return fn
    return deco


def known_rules() -> tuple:
    """Sorted names of every registered lint rule."""
    return tuple(sorted(_RULES))


# --------------------------------------------------------------------------
# AST helpers shared by the rules
# --------------------------------------------------------------------------

def _dotted(node) -> str:
    """``a.b.c`` for a Name/Attribute chain, '' when it is anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_scope(nodes) -> Iterator:
    """All nodes under ``nodes``, not descending into nested functions
    (their bodies run when called, not here)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, _FUNCS):
                stack.append(child)


def _inside_loop_body(node, parents: dict) -> bool:
    child, parent = node, parents.get(node)
    while parent is not None:
        if isinstance(parent, _FUNCS):
            return False           # new scope: built per call instead
        if isinstance(parent, (ast.For, ast.AsyncFor)) \
                and child is not parent.target and child is not parent.iter:
            return True
        if isinstance(parent, ast.While) and child is not parent.test:
            return True
        child, parent = parent, parents.get(parent)
    return False


_SCALAR_TYPES = frozenset({"int", "float", "bool", "str"})


def _param_names(fn) -> set:
    """The parameters that may hold a tensor: not ``self``/``cls``, not
    annotated as a Python scalar."""
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    names = [p.arg for p in params
             if not (isinstance(p.annotation, ast.Name)
                     and p.annotation.id in _SCALAR_TYPES)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return {n for n in names if n not in ("self", "cls")}


def _tainted_names(fn, params: set) -> set:
    """Params plus names transitively assigned from them (fixpoint)."""
    tainted = set(params)
    assigns = [n for n in _walk_scope(fn.body)
               if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            value = node.value
            if value is None:
                continue
            loads = {m.id for m in ast.walk(value)
                     if isinstance(m, ast.Name)
                     and isinstance(m.ctx, ast.Load)}
            if not loads & tainted:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for m in ast.walk(t):
                    if isinstance(m, ast.Name) and m.id not in tainted:
                        tainted.add(m.id)
                        changed = True
    return tainted


# --------------------------------------------------------------------------
# Rule: jax-import
# --------------------------------------------------------------------------

#: Top-level packages the port never imports.
FORBIDDEN_PACKAGES = frozenset({"jax", "jaxlib", "flax", "repro"})


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_PACKAGES


@register_rule("jax-import")
def jax_import(ctx: FileContext):
    """An import of jax, jaxlib, flax or the JAX package, at any depth."""
    for node in ast.walk(ctx.tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args \
                and _dotted(node.func) in ("importlib.import_module",
                                           "import_module", "__import__") \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            names = [node.args[0].value]
        for name in names:
            if _forbidden(name):
                yield node, (f"imports {name!r}: the port imports neither "
                             "jax nor the JAX package (keep a copy of what "
                             "it needs in repro_torch)")


# --------------------------------------------------------------------------
# Rule: kernel-fallback
# --------------------------------------------------------------------------

def _kernel_call(node) -> str:
    """The spelling of a call that builds or launches a kernel, else ''."""
    if not isinstance(node, ast.Call):
        return ""
    name = _dotted(node.func)
    last = name.rpartition(".")[2]
    if name.endswith("_build.build") or last.startswith("launch"):
        return name
    if isinstance(node.func, ast.Call) \
            and isinstance(node.func.func, ast.Attribute) \
            and node.func.func.attr == "fn":         # lib.fn(name, dtype)(...)
        return _dotted(node.func.func) + "(...)"
    return ""


def _reraises(handler: ast.ExceptHandler) -> bool:
    """The handler ends in a ``raise`` and returns nowhere else."""
    if not handler.body or not isinstance(handler.body[-1], ast.Raise):
        return False
    return not any(isinstance(n, (ast.Return, ast.Break, ast.Continue))
                   for n in _walk_scope(handler.body))


@register_rule("kernel-fallback")
def kernel_fallback(ctx: FileContext):
    """A try around a kernel build or launch whose handler goes on."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try) or not node.handlers:
            continue
        calls = [c for c in (_kernel_call(n) for n in _walk_scope(node.body))
                 if c]
        if not calls:
            continue
        for handler in node.handlers:
            if not _reraises(handler):
                yield handler, (f"handler of a try around {calls[0]} does "
                                "not re-raise: a CUDA tensor launches the "
                                "kernel or raises, it never falls back to "
                                "the plain version")


# --------------------------------------------------------------------------
# Rule: import-time-build
# --------------------------------------------------------------------------

def _is_main_guard(node) -> bool:
    t = node.test if isinstance(node, ast.If) else None
    return isinstance(t, ast.Compare) and _dotted(t.left) == "__name__" \
        and any(isinstance(c, ast.Constant) and c.value == "__main__"
                for c in t.comparators)


def _module_level(tree: ast.Module) -> Iterator:
    """Nodes that run when the module is imported: the module's statements
    and class bodies, not function bodies, not the ``__main__`` block."""
    stack = [s for s in tree.body if not _is_main_guard(s)]
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNCS):
            # decorators and defaults run at import, the body does not
            stack.extend(getattr(node, "decorator_list", []))
            stack.extend(d for d in node.args.defaults
                         + node.args.kw_defaults if d is not None)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _cuda_device(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.split(":")[0] == "cuda"


def _build_at_import(node) -> str:
    if isinstance(node, ast.Import):
        if any(a.name.split(".")[0] == "triton" for a in node.names):
            return "import triton"
        return ""
    if isinstance(node, ast.ImportFrom):
        return "import triton" if (node.module or "").split(".")[0] \
            == "triton" else ""
    if not isinstance(node, ast.Call):
        return ""
    name = _dotted(node.func)
    if name.endswith("_build.build") or name == "ctypes.CDLL" \
            or name.startswith(("subprocess.", "torch.cuda.")):
        return name
    if isinstance(node.func, ast.Attribute) and node.func.attr == "cuda":
        return ".cuda()"
    if isinstance(node.func, ast.Attribute) and node.func.attr == "to" \
            and node.args and _cuda_device(node.args[0]):
        return ".to('cuda')"
    if any(kw.arg == "device" and _cuda_device(kw.value)
           for kw in node.keywords):
        return f"{name or 'a call'}(device='cuda')"
    return ""


@register_rule("import-time-build")
def import_time_build(ctx: FileContext):
    """A module-level call that compiles, loads or touches the card."""
    for node in _module_level(ctx.tree):
        what = _build_at_import(node)
        if what:
            yield node, (f"{what} runs when the module is imported: build "
                         "kernels and touch the card at first use, inside "
                         "the function that needs them")


# --------------------------------------------------------------------------
# Rule: host-sync-in-hot-path
# --------------------------------------------------------------------------

#: Functions whose every call is on a hot path: the engines' decode steps,
#: the fused pricing and the streaming chunk, the train step.
HOT_FUNCTIONS = ("decode_step", "_decode_active", "_decode_paged",
                 "_paged_step", "_chunk_step", "price_grid_fused",
                 "price_topk_chunk", "topk_chunk_tensors", "train_step")

_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_CASTS = frozenset({"float", "int", "bool"})


def _is_custom_op(fn) -> bool:
    for d in fn.decorator_list:
        target = d.func if isinstance(d, ast.Call) else d
        if _dotted(target).endswith("library.custom_op"):
            return True
    return False


@register_rule("host-sync-in-hot-path", hot=HOT_FUNCTIONS)
def host_sync_in_hot_path(ctx: FileContext, hot=()):
    """Host syncs inside a custom op body or a hot function."""
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name not in hot and not _is_custom_op(fn):
            continue
        tainted = _tainted_names(fn, _param_names(fn))
        where = f"custom op {fn.name!r}" if _is_custom_op(fn) \
            else f"hot {fn.name!r}"
        for node in _walk_scope(fn.body):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name == "torch.cuda.synchronize":
                yield node, (f"torch.cuda.synchronize() inside {where} "
                             "stalls the host on every call")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                yield node, (f".{node.func.attr}() inside {where} copies to "
                             "the host and waits for the card")
            elif name in _HOST_CASTS and len(node.args) == 1 \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in tainted:
                yield node, (f"{name}() of {node.args[0].id!r} inside "
                             f"{where} waits for the card when it is a "
                             "tensor")


# --------------------------------------------------------------------------
# Rule: compile-in-loop
# --------------------------------------------------------------------------

_COMPILE_NAMES = frozenset({"torch.compile", "make_fx", "capture",
                            "graph.capture", "core.graph.capture",
                            "torch.cuda.CUDAGraph", "CUDAGraph"})


@register_rule("compile-in-loop")
def compile_in_loop(ctx: FileContext):
    """A capture, compile or CUDA graph built per loop iteration."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in _COMPILE_NAMES or name.endswith(".make_fx"):
            if _inside_loop_body(node, ctx.parents):
                yield node, (f"{name}(...) inside a loop body captures or "
                             "compiles every iteration: hoist it out of the "
                             "loop")


# --------------------------------------------------------------------------
# Rule: default-dtype-leak
# --------------------------------------------------------------------------

def _dtype_switch(node) -> str:
    """The process-wide switch ``node`` sets, else ''."""
    if isinstance(node, ast.Call) \
            and _dotted(node.func) == "torch.set_default_dtype":
        return "torch.set_default_dtype"
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            name = _dotted(t)
            if name.startswith("torch.backends.") \
                    and name.endswith(".allow_tf32"):
                return name
    return ""


def _restored(fn, what: str) -> bool:
    """``fn`` sets ``what`` again in a ``finally`` block."""
    for node in _walk_scope(fn.body):
        if isinstance(node, ast.Try) and any(
                _dtype_switch(n) == what for n in _walk_scope(node.finalbody)):
            return True
    return False


@register_rule("default-dtype-leak")
def default_dtype_leak(ctx: FileContext):
    """A process-wide dtype or TF32 switch that is never restored."""
    for node in ast.walk(ctx.tree):
        what = _dtype_switch(node)
        if not what:
            continue
        scope = ctx.parents.get(node)
        while scope is not None and not isinstance(scope, _FUNCS):
            scope = ctx.parents.get(scope)
        if scope is not None and not isinstance(scope, ast.Lambda) \
                and _restored(scope, what):
            continue
        yield node, (f"{what} changes every later computation of the "
                     "process: restore it in a finally block of the "
                     "function that sets it")


# --------------------------------------------------------------------------
# Rule: unknown-noqa
# --------------------------------------------------------------------------

_NOQA_RE = re.compile(r"#\s*repro_torch:\s*noqa(?:\[([\w\-,\s]*)\])?")


@register_rule("unknown-noqa")
def unknown_noqa(ctx: FileContext):
    """``# repro_torch: noqa[rule]`` pragmas naming an unregistered rule.

    Only real COMMENT tokens count: a docstring showing the pragma syntax
    as an example is not a pragma.
    """
    import io
    import tokenize
    reader = io.StringIO("\n".join(ctx.lines)).readline
    try:
        comments = [(tok.start[0], tok.string)
                    for tok in tokenize.generate_tokens(reader)
                    if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return
    for lineno, text in comments:
        m = _NOQA_RE.search(text)
        if m is None or m.group(1) is None:
            continue
        for name in sorted({s.strip() for s in m.group(1).split(",")
                            if s.strip()}):
            if name not in _RULES:
                yield lineno, (
                    f"noqa pragma names unregistered rule {name!r}: a "
                    "typo'd pragma suppresses nothing and rots "
                    f"(registered: {', '.join(known_rules())})")


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------


def _suppressed(lines: list, finding: Finding) -> bool:
    if not (0 < finding.line <= len(lines)):
        return False
    m = _NOQA_RE.search(lines[finding.line - 1])
    if not m:
        return False
    if m.group(1) is None:
        return True
    return finding.rule in {s.strip() for s in m.group(1).split(",")
                            if s.strip()}


def _active_rules(select=None) -> list:
    if select is None:
        return [_RULES[n] for n in known_rules()]
    unknown = set(select) - set(_RULES)
    if unknown:
        raise ValueError(f"unknown lint rule(s) {sorted(unknown)} "
                         f"(registered: {', '.join(known_rules())})")
    return [_RULES[n] for n in known_rules() if n in set(select)]


def lint_file(path, rel: str | None = None, select=None) -> list:
    """Lint one file; returns sorted, pragma-filtered :class:`Finding`\\ s."""
    path = Path(path)
    rel = (rel or str(path)).replace("\\", "/")
    source = path.read_text()
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 0, "syntax-error", e.msg or "")]
    ctx = FileContext(path=path, rel=rel, tree=tree, lines=lines)
    findings = set()
    for rule in _active_rules(select):
        if not rule.applies_to(rel):
            continue
        for node, message in rule.run(ctx):
            line = node if isinstance(node, int) \
                else getattr(node, "lineno", 0)
            findings.add(Finding(rel, line, rule.name, message))
    return sorted(f for f in findings if not _suppressed(lines, f))


def iter_py_files(paths) -> Iterator:
    """Yield every ``.py`` file under the given files/directories."""
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        else:
            yield p


def lint_paths(paths, select=None) -> list:
    """Lint files/directories; findings sorted by (path, line, rule)."""
    findings = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f, select=select))
    return sorted(findings)


#: What ``python -m repro_torch.lint`` lints when given no path: the port
#: and its chip script, from the root of a checkout.
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="the port's AST linter (no jax import, no kernel "
                    "fallback, no import-time build, hot-path and dtype "
                    "hygiene); exits nonzero on findings")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--select", default=None, metavar="RULES",
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="findings as text lines (default) or one JSON "
                         "report for CI artifacts")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the registered rules and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in known_rules():
            print(f"{name:22s} {_RULES[name].doc}")
        return 0

    paths = args.paths or [p for p in DEFAULT_PATHS if Path(p).exists()]
    select = None
    if args.select:
        select = [s.strip() for s in args.select.split(",") if s.strip()]
    try:
        findings = lint_paths(paths, select=select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    n_files = sum(1 for _ in iter_py_files(paths))
    if args.format == "json":
        print(json.dumps({"tool": "repro_torch.lint", "n_files": n_files,
                          "n_findings": len(findings),
                          "findings": [dataclasses.asdict(f)
                                       for f in findings]},
                         indent=2))
    else:
        for f in findings:
            print(f)
    status = f"{len(findings)} finding(s) in {n_files} file(s)"
    print(f"repro_torch.lint: {status}", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
