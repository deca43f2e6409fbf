"""AST host-discipline linter for the serving stack's host/device split
(port of `repro.analysis.host_lint`, in PyTorch's terms).

The engines' contract is that scheduling is host work *between* device
steps: numpy state, an explicit read (`.item()`, `.tolist()`, `.cpu()`,
`.numpy()`, `.to("cpu")`: the counterpart of `jax.device_get`) at the few
points a decision needs device bytes, allocator mutation only from host
code, and `PoolExhausted` raised before a step is launched. This linter
enforces that contract statically over the port's `launch/serve.py`,
`launch/prefill.py`, `launch/frontend.py`, `models/paging.py` and
`obs/*`.

Modules declare their own topology in a module-level `__analysis__`
dict (parsed with `ast.literal_eval` — it must stay a pure literal):

    __analysis__ = {
        # the device steps: functions whose work runs on the device, the
        # port's counterpart of the reference's jit / scan bodies
        # (qualnames; entries with a module prefix, e.g.
        # "paging.adopt_prefill", document steps defined in another
        # module), and every CUDA-graph / torch.compile / torch.jit
        # target (HL205)
        "traced": ("Engine._step", ...),
        # the per-step scheduler loop(s): HL201/HL202 scope
        "host_loop": ("Engine.run", ...),
        # call-chain suffixes whose results are device tensors
        "device_returning": ("sched.run", ...),
        # "Qualname.param" names that arrive as device tensors
        "device_params": ("SwapStore._to_host.groups", ...),
        # host-side scheduling objects: never device values, so taint
        # cannot attach to these names
        "host_objects": ("sched", "index", "allocator", "swap"),
    }

Checks:

HL201  a `torch.*` call in a host-loop function that is not data movement
       (`tensor`, `as_tensor`, `from_numpy`, `zeros`, `empty`, `full`,
       `ones`, `arange`, `cat`, `stack`, their `_like` forms, `no_grad`,
       `torch.cuda.*`), or a tensor math method (`TENSOR_MATH`: `sum`,
       `argmax`, `add`, ...) on a device tensor there. Data movement
       methods (`to`, `copy_`, views) and index writes are allowed. Math
       belongs inside a declared step: host-side math launches device
       kernels once a scheduler iteration.
HL202  an implicit device sync in a host-loop function: `int()`,
       `float()`, `bool()`, `np.asarray` / `np.array` of a value tainted
       as a device tensor, or branching (`if` / `while` / `assert`) on
       one. The explicit reads clear the taint and are not findings.
HL203  `PageAllocator` / `PrefixIndex` / `SwapStore` mutation reachable
       from a device step — allocator state must only change on the host
       between steps.
HL204  `raise PoolExhausted` inside a device step — the pool-dry signal
       must fire before the step is launched.
HL205  a `torch.compile` / `torch.jit.script` / `torch.jit.trace` /
       `torch.cuda.make_graphed_callables` target, a function decorated
       with one, or a module function called inside a `torch.cuda.graph`
       capture block, that is not in the module's `traced` annotation
       (and not nested inside a traced function): every captured or
       compiled entry point must be declared so the other checks know
       the host/device boundary. A module without `__analysis__` fails
       wholesale.

Taint for HL202 is a per-function fixpoint over simple names and
attribute chains: seeds are `torch.*` constructors given a `device=` (not
the literal "cpu"), `torch.*` calls on tainted arguments, `.to(<device>)`
and `.cuda()`, calls of the module's declared steps (`self.X(...)` where
`Cls.X` is traced) and of compiled attributes (`self.X = torch.compile(
...)`), annotated `device_returning` call chains, and annotated
`device_params`; taint flows through assignment, tuple unpacking,
containers, subscript *reads* (of the container — a tainted index into a
host array is not a sync), comprehensions (generator targets bound from
their iterables, `enumerate`'s index a host int, `zip` position by
position), tensor-returning and accessor methods (`TAINT_METHODS`), and
`append`-style mutation. A tensor's `shape`,
`dtype`, `device` and `ndim` are host values. Other method calls are
assumed host-returning, and bare-name truthiness tests are host `len()`
checks — deliberate precision-over-recall calls, as in the reference.
Nested `def`s are analyzed inside their parent's environment (closures
share the loop's variables).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import (Finding, HL_LOOP_NUMERIC,
                                           HL_LOOP_SYNC, HL_TRACED_MUT,
                                           HL_TRACED_RAISE, HL_UNANNOTATED)

#: the serving-stack host modules the CLI lints by default (repo-relative)
DEFAULT_TARGETS = (
    "src/repro_torch/launch/serve.py",
    "src/repro_torch/launch/prefill.py",
    "src/repro_torch/launch/frontend.py",
    "src/repro_torch/models/paging.py",
    "src/repro_torch/obs/__init__.py",
    "src/repro_torch/obs/metrics.py",
    "src/repro_torch/obs/tracing.py",
    "src/repro_torch/obs/export.py",
)

#: `torch.*` calls that move or allocate data and compute nothing
ALLOWED_HOST_CALLS = frozenset({
    "tensor", "as_tensor", "from_numpy", "zeros", "zeros_like", "ones",
    "ones_like", "empty", "empty_like", "full", "full_like", "arange",
    "cat", "stack", "no_grad", "inference_mode", "device", "is_tensor",
    "is_grad_enabled", "get_num_threads", "set_num_threads",
})
#: tensor methods that compute on the device (HL201 on a device tensor
#: in a host loop); their results are device tensors
TENSOR_MATH = frozenset({
    "abs", "add", "add_", "all", "amax", "amin", "any", "argmax", "argmin",
    "argsort", "ceil", "clamp", "clamp_", "cumsum", "div", "div_", "eq",
    "exp", "floor", "ge", "gt", "le", "log", "lt", "masked_fill", "matmul",
    "max", "mean", "min", "mul", "mul_", "ne", "neg", "pow", "prod",
    "round", "softmax", "sort", "sqrt", "sub", "sub_", "sum", "topk",
    "where",
})
#: the explicit device-to-host reads: host results, never findings
EXPLICIT_READS = frozenset({"item", "tolist", "cpu", "numpy"})
#: tensor attributes that are host values
HOST_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                        "layout"})
PASSTHROUGH = frozenset({"list", "tuple", "dict", "set", "sorted",
                         "reversed", "zip", "enumerate", "min", "max"})
MUTATING_METHODS = frozenset({"append", "extend", "add", "insert",
                              "update", "setdefault"})
#: methods whose result carries the receiver's taint: container
#: accessors and tensor-returning data movement (and `TENSOR_MATH`). Any
#: *other* method call is assumed host-returning — the linter trades
#: recall for precision here, as the reference's does.
TAINT_METHODS = frozenset({
    "items", "values", "get", "pop", "popitem", "copy", "to", "clone",
    "contiguous", "view", "reshape", "narrow", "flatten", "squeeze",
    "unsqueeze", "expand", "index_select", "repeat", "transpose",
    "permute", "float", "long", "int", "half", "bfloat16", "type",
}) | TENSOR_MATH
SYNC_BUILTINS = frozenset({"int", "float", "bool"})
NP_SINKS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                      "numpy.array"})
ALLOC_TYPES = frozenset({"PageAllocator", "PrefixIndex", "SwapStore"})
ALLOC_MUTATORS = frozenset({"alloc", "share", "release", "free", "insert",
                            "invalidate", "put", "pop", "cancel"})
#: calls whose first argument becomes captured or compiled device code
COMPILE_ENTRY = frozenset({"torch.compile", "torch.jit.script",
                           "torch.jit.trace",
                           "torch.cuda.make_graphed_callables"})
GRAPH_CAPTURE = "torch.cuda.graph"


def _chain(node) -> Optional[str]:
    """Dotted-name string of a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _own_nodes(fn: ast.AST):
    """Walk a function body without descending into nested function or
    class definitions (those are attributed to their own qualnames)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def _is_cpu(node) -> bool:
    """A literal naming the CPU: "cpu" or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and _chain(node.func) == "torch.device":
        return bool(node.args) and _is_cpu(node.args[0])
    return False


def _names_device(node) -> bool:
    """An argument of `.to()` that names a device: a device literal, or a
    name whose last part speaks of one (`dev`, `self.device`)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Call) and _chain(node.func) == "torch.device":
        return True
    ch = _chain(node)
    return bool(ch) and "dev" in ch.split(".")[-1].lower()


class _Module:
    """Parsed module index: qualnamed functions, nesting, compiled attrs,
    allocator-typed bindings, every call site and `with` block with its
    context, decorated functions."""

    def __init__(self, path: str, rel: str):
        with open(path) as fh:
            self.tree = ast.parse(fh.read(), filename=path)
        self.rel = rel
        self.funcs: Dict[str, ast.AST] = {}
        self.parents: Dict[str, Optional[str]] = {}
        self.owner: Dict[str, Optional[str]] = {}
        self.compiled_attrs: Set[str] = set()
        self.alloc_refs: Set[str] = set()       # names/attrs of allocators
        self.calls: List[Tuple[ast.Call, Optional[str],
                               Optional[str]]] = []
        self.withs: List[Tuple[ast.With, Optional[str],
                               Optional[str]]] = []
        self.ann: Optional[dict] = None
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__analysis__"
                    for t in node.targets):
                self.ann = ast.literal_eval(node.value)
        self._walk(self.tree, None, None)

    def _record_assign(self, node: ast.Assign) -> None:
        if not isinstance(node.value, ast.Call):
            return
        ch = _chain(node.value.func)
        if ch is None:
            return
        final = ch.split(".")[-1]
        for tgt in node.targets:
            tch = _chain(tgt)
            if tch is None:
                continue
            attr = tch.split(".")[-1]
            if ch in COMPILE_ENTRY:
                self.compiled_attrs.add(attr)
            if final in ALLOC_TYPES:
                self.alloc_refs.add(attr)

    def _walk(self, node, cls: Optional[str], fnq: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self._walk(child, child.name, None)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if fnq is not None:
                    q = f"{fnq}.{child.name}"
                elif cls is not None:
                    q = f"{cls}.{child.name}"
                else:
                    q = child.name
                self.funcs[q] = child
                self.parents[q] = fnq
                self.owner[q] = cls
                self._walk(child, cls, q)
            else:
                if isinstance(child, ast.Assign):
                    self._record_assign(child)
                if isinstance(child, ast.Call):
                    self.calls.append((child, cls, fnq))
                if isinstance(child, ast.With):
                    self.withs.append((child, cls, fnq))
                self._walk(child, cls, fnq)


# ----------------------------------------------------------------- scopes

def _resolve(m: _Module, ch: str, q: Optional[str]) -> Optional[str]:
    """The qualname a call chain names in this module: a function, or
    `self.X` in the calling method's class."""
    if ch in m.funcs:
        return ch
    if q and ch.startswith("self.") and ch.count(".") == 1 \
            and m.owner.get(q):
        qual = f"{m.owner[q]}.{ch[5:]}"
        if qual in m.funcs:
            return qual
    return None


def _traced_scope(m: _Module, traced: Sequence[str]) -> Set[str]:
    """Local traced functions closed over nesting and simple-name calls."""
    scope = {q for q in traced if q in m.funcs}
    changed = True
    while changed:
        changed = False
        for q in m.funcs:
            if q in scope:
                continue
            if m.parents[q] in scope:        # nested def under a traced fn
                scope.add(q)
                changed = True
        for q in list(scope):
            for node in _own_nodes(m.funcs[q]):
                if not isinstance(node, ast.Call):
                    continue
                ch = _chain(node.func)
                cand = _resolve(m, ch, q) if ch else None
                if cand and cand not in scope:
                    scope.add(cand)
                    changed = True
    return scope


# ------------------------------------------------------- HL203 / HL204

def _check_traced(m: _Module, scope: Set[str]) -> List[Finding]:
    out = []
    for q in sorted(scope):
        for node in _own_nodes(m.funcs[q]):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ALLOC_MUTATORS:
                base = _chain(node.func.value)
                if base and base.split(".")[-1] in m.alloc_refs:
                    out.append(Finding(
                        HL_TRACED_MUT, m.rel, node.lineno, q,
                        f"`{base}.{node.func.attr}(...)` mutates "
                        f"allocator state from a device step — "
                        f"allocator updates belong on the host between "
                        f"steps"))
            if isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc.func if isinstance(node.exc, ast.Call) \
                    else node.exc
                ech = _chain(exc)
                if ech and ech.split(".")[-1] == "PoolExhausted":
                    out.append(Finding(
                        HL_TRACED_RAISE, m.rel, node.lineno, q,
                        "`raise PoolExhausted` inside a device step — the "
                        "pool-dry signal must fire host-side before the "
                        "step is launched"))
    return out


# --------------------------------------------------------------- HL205

def _declared(m: _Module, tch: Optional[str], cls: Optional[str],
              fnq: Optional[str], traced: Sequence[str],
              scope: Set[str]) -> bool:
    if not tch:
        return False
    if tch in traced:
        return True
    if tch.startswith("self.") and cls and f"{cls}.{tch[5:]}" in traced:
        return True
    return bool(fnq) and f"{fnq}.{tch}" in scope   # nested def of a traced


def _unannotated(m: _Module, line: int, scope_name: str, what: str,
                 target: str) -> Finding:
    return Finding(HL_UNANNOTATED, m.rel, line, scope_name,
                   f"`{what}` target `{target}` is not listed in this "
                   f"module's __analysis__ 'traced' annotation")


def _check_entry_points(m: _Module, traced: Sequence[str],
                        scope: Set[str]) -> List[Finding]:
    out = []
    for call, cls, fnq in m.calls:
        ch = _chain(call.func)
        if ch not in COMPILE_ENTRY or fnq in scope or not call.args:
            continue                 # compile inside already-traced code
        tgt = call.args[0]
        tch = _chain(tgt)
        ok = _declared(m, tch, cls, fnq, traced, scope) or (
            isinstance(tgt, ast.Lambda) and fnq in scope)
        if not ok:
            out.append(_unannotated(m, call.lineno, fnq or m.rel, ch,
                                    tch or "<dynamic>"))
    for q, fn in m.funcs.items():
        for dec in fn.decorator_list:
            dch = _chain(dec.func if isinstance(dec, ast.Call) else dec)
            if dch in COMPILE_ENTRY and q not in scope:
                out.append(_unannotated(m, fn.lineno, q, f"@{dch}", q))
    for node, cls, fnq in m.withs:
        if fnq in scope or not any(
                isinstance(it.context_expr, ast.Call)
                and _chain(it.context_expr.func) == GRAPH_CAPTURE
                for it in node.items):
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                sch = _chain(sub.func)
                q = _resolve(m, sch, fnq) if sch else None
                if q and not _declared(m, sch, cls, fnq, traced, scope):
                    out.append(_unannotated(m, sub.lineno, fnq or m.rel,
                                            GRAPH_CAPTURE, sch))
    return out


# ------------------------------------------------------ HL201 / HL202

class _HostFnLint:
    def __init__(self, m: _Module, q: str, traced: Sequence[str]):
        self.m = m
        self.q = q
        self.fn = m.funcs[q]
        self.cls = m.owner.get(q)
        self.traced = frozenset(traced)
        ann = m.ann or {}
        self.dev_returning = tuple(ann.get("device_returning", ()))
        self.host_objects = frozenset(ann.get("host_objects", ()))
        self.taint: Set[str] = set()
        prefix = f"{q}."
        for entry in ann.get("device_params", ()):
            if entry.startswith(prefix):
                self.taint.add(entry[len(prefix):])

    # ------------------------------------------------------- expressions
    def _is_step(self, parts: List[str]) -> bool:
        """`self.X(...)` where X is a declared step or compiled attr."""
        return parts[0] == "self" and len(parts) == 2 and (
            parts[1] in self.m.compiled_attrs
            or (self.cls is not None
                and f"{self.cls}.{parts[1]}" in self.traced))

    def _torch_tainted(self, e: ast.Call, parts: List[str]) -> bool:
        if len(parts) > 1 and parts[1] == "cuda":
            return False             # streams, events, synchronize
        for kw in e.keywords:
            if kw.arg == "device":
                if not _is_cpu(kw.value):
                    return True
            elif kw.arg not in ("dtype", "out") and self._tainted(kw.value):
                return True
        return any(self._tainted(a) for a in e.args)

    def _method_tainted(self, e: ast.Call) -> bool:
        meth = e.func.attr
        if meth in EXPLICIT_READS:
            return False
        if meth == "to":
            args = list(e.args) + [kw.value for kw in e.keywords
                                   if kw.arg == "device"]
            if any(_is_cpu(a) for a in args):
                return False         # an explicit read
            if any(_names_device(a) for a in args):
                return True          # a copy onto the device
        if meth == "cuda":
            return True
        return meth in TAINT_METHODS and self._tainted(e.func.value)

    def _call_tainted(self, e: ast.Call) -> bool:
        ch = _chain(e.func)
        if ch:
            parts = ch.split(".")
            if parts[0] == "torch":
                return self._torch_tainted(e, parts)
            if self._is_step(parts):
                return True
            if any(ch == d or ch.endswith("." + d)
                   for d in self.dev_returning):
                return True
            if ch in PASSTHROUGH:
                return any(self._tainted(a) for a in e.args)
            if ch in NP_SINKS or ch in SYNC_BUILTINS:
                return False         # sinks produce host values
        if isinstance(e.func, ast.Attribute):
            return self._method_tainted(e)
        return False

    def _tainted(self, e) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Name):
            return e.id in self.taint
        if isinstance(e, ast.Attribute):
            if e.attr in HOST_ATTRS:
                return False
            ch = _chain(e)
            return (ch in self.taint) or self._tainted(e.value)
        if isinstance(e, ast.Subscript):
            return self._tainted(e.value)
        if isinstance(e, ast.Call):
            return self._call_tainted(e)
        if isinstance(e, ast.BinOp):
            return self._tainted(e.left) or self._tainted(e.right)
        if isinstance(e, ast.BoolOp):
            return any(self._tainted(v) for v in e.values)
        if isinstance(e, ast.Compare):
            return self._tainted(e.left) or any(
                self._tainted(c) for c in e.comparators)
        if isinstance(e, ast.UnaryOp):
            return self._tainted(e.operand)
        if isinstance(e, ast.IfExp):
            return any(self._tainted(x) for x in (e.body, e.orelse))
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self._tainted(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self._tainted(x) for x in e.values if x) or any(
                self._tainted(x) for x in e.keys if x)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            return self._comp_tainted(e)
        if isinstance(e, ast.Starred):
            return self._tainted(e.value)
        if isinstance(e, ast.NamedExpr):
            return self._tainted(e.value)
        return False

    def _comp_tainted(self, e) -> bool:
        """A comprehension is tainted iff its *element* is — with the
        generator targets bound from their iterables first, so
        `[t for _, t in history]` (device tokens) is tainted while
        `[(i, s) for i, (a, _) in enumerate(history)]` (host indices
        into a tainted container) is not."""
        added: List[str] = []
        try:
            for g in e.generators:       # in order: later iters may use
                for t in self._iter_targets(g.target, g.iter):
                    for n in ast.walk(t):    # earlier targets
                        if isinstance(n, ast.Name) \
                                and n.id not in self.taint \
                                and n.id not in self.host_objects:
                            self.taint.add(n.id)
                            added.append(n.id)
            if isinstance(e, ast.DictComp):
                return self._tainted(e.key) or self._tainted(e.value)
            return self._tainted(e.elt)
        finally:
            for name in added:
                self.taint.discard(name)

    def _iter_targets(self, target, it) -> List[ast.AST]:
        """The parts of a loop target that an iterable binds to device
        values: `enumerate`'s index never is, `zip` binds position by
        position, an `if`-expression binds as either branch, a literal
        sequence of tuples position by position; any other tainted
        iterable binds the whole target."""
        if isinstance(it, ast.IfExp):
            return self._iter_targets(target, it.body) + \
                self._iter_targets(target, it.orelse)
        if isinstance(target, ast.Tuple) and len(target.elts) == 2 \
                and isinstance(it, ast.Call) and _chain(it.func) == \
                "enumerate" and it.args:
            return [target.elts[1]] if self._tainted(it.args[0]) else []
        if isinstance(target, ast.Tuple) and isinstance(it, ast.Call) \
                and _chain(it.func) == "zip" and not it.keywords \
                and len(it.args) == len(target.elts):
            return [t for t, a in zip(target.elts, it.args)
                    if self._tainted(a)]
        if isinstance(target, ast.Tuple) \
                and isinstance(it, (ast.List, ast.Tuple)) and it.elts \
                and all(isinstance(x, ast.Tuple)
                        and len(x.elts) == len(target.elts)
                        for x in it.elts):
            return [t for i, t in enumerate(target.elts)
                    if any(self._tainted(x.elts[i]) for x in it.elts)]
        return [target] if self._tainted(it) else []

    # -------------------------------------------------------- statements
    def _bind(self, target) -> None:
        if isinstance(target, ast.Name):
            if target.id not in self.host_objects:
                self.taint.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self._bind(t)
        elif isinstance(target, ast.Starred):
            self._bind(target.value)
        elif isinstance(target, ast.Attribute):
            ch = _chain(target)
            if ch:
                self.taint.add(ch)
        elif isinstance(target, ast.Subscript):
            self._bind(target.value)     # writing into a container taints it

    def _propagate_once(self) -> int:
        before = len(self.taint)
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Assign):
                val_t = self._tainted(node.value)
                if len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Tuple) \
                        and isinstance(node.value, ast.Tuple) \
                        and len(node.targets[0].elts) == \
                        len(node.value.elts):
                    for t, v in zip(node.targets[0].elts,
                                    node.value.elts):
                        if self._tainted(v):
                            self._bind(t)
                elif val_t:
                    for t in node.targets:
                        self._bind(t)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if self._tainted(node.value):
                    self._bind(node.target)
            elif isinstance(node, ast.AugAssign):
                if self._tainted(node.value) or self._tainted(node.target):
                    self._bind(node.target)
            elif isinstance(node, ast.For):
                for t in self._iter_targets(node.target, node.iter):
                    self._bind(t)
            elif isinstance(node, ast.NamedExpr):
                if self._tainted(node.value):
                    self._bind(node.target)
            elif isinstance(node, ast.withitem):
                if node.optional_vars is not None \
                        and self._tainted(node.context_expr):
                    self._bind(node.optional_vars)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATING_METHODS:
                if any(self._tainted(a) for a in node.args):
                    self._bind(node.func.value)
        return len(self.taint) - before

    # -------------------------------------------------------------- emit
    def _numeric(self, node, what: str) -> Finding:
        return Finding(
            HL_LOOP_NUMERIC, self.m.rel, node.lineno, self.q,
            f"`{what}` in the host scheduler loop — device math belongs "
            f"inside a declared step, not per host iteration")

    def run(self) -> List[Finding]:
        for _ in range(16):              # fixpoint (loops carry taint back)
            if self._propagate_once() == 0:
                break
        out = []
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Call):
                ch = _chain(node.func)
                if ch:
                    parts = ch.split(".")
                    if parts[0] == "torch" and len(parts) > 1 \
                            and parts[1] != "cuda" \
                            and parts[-1] not in ALLOWED_HOST_CALLS:
                        out.append(self._numeric(node, ch))
                    if ch in NP_SINKS and any(self._tainted(a)
                                              for a in node.args):
                        out.append(self._sync(node, f"`{ch}`"))
                    if ch in SYNC_BUILTINS and any(self._tainted(a)
                                                   for a in node.args):
                        out.append(self._sync(node, f"`{ch}()`"))
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in TENSOR_MATH \
                        and self._tainted(node.func.value):
                    out.append(self._numeric(node, f".{node.func.attr}()"))
            elif isinstance(node, (ast.If, ast.While)) \
                    and self._test_syncs(node.test):
                out.append(self._sync(node, "branching"))
            elif isinstance(node, ast.Assert) \
                    and self._test_syncs(node.test):
                out.append(self._sync(node, "asserting"))
        return out

    def _test_syncs(self, test) -> bool:
        """Does this branch condition read device bytes? Truthiness of a
        bare (possibly tainted) name is a host `len()` check on a
        container that merely *holds* device tensors — only comparisons,
        subscript reads, calls and arithmetic over tainted values force
        a device round trip."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._test_syncs(test.operand)
        if isinstance(test, ast.BoolOp):
            return any(self._test_syncs(v) for v in test.values)
        if isinstance(test, (ast.Name, ast.Attribute)):
            return False
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return False             # identity test — never reads bytes
        return self._tainted(test)

    def _sync(self, node, what: str) -> Finding:
        return Finding(
            HL_LOOP_SYNC, self.m.rel, node.lineno, self.q,
            f"{what} on a device tensor in the host scheduler loop is an "
            f"implicit sync — read it explicitly (.item() / .tolist() / "
            f".cpu(), batched, off the per-step path)")


# ----------------------------------------------------------------- entry

def _repo_root() -> str:
    return os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..", ".."))


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    rel = rel or path
    m = _Module(path, rel)
    if m.ann is None:
        return [Finding(HL_UNANNOTATED, rel, 1, rel,
                        "module has no __analysis__ annotation — declare "
                        "its traced / host-loop topology")]
    traced = tuple(m.ann.get("traced", ()))
    scope = _traced_scope(m, traced)
    out = _check_entry_points(m, traced, scope)
    out += _check_traced(m, scope)
    for q in m.ann.get("host_loop", ()):
        if q not in m.funcs:
            out.append(Finding(
                HL_UNANNOTATED, rel, 1, rel,
                f"__analysis__ host_loop entry {q!r} names no function "
                f"in this module"))
            continue
        out += _HostFnLint(m, q, traced).run()
    return sorted(out, key=lambda f: (f.file, f.line, f.check))


def lint_all(targets: Sequence[str] = DEFAULT_TARGETS,
             root: Optional[str] = None) -> List[Finding]:
    root = root or _repo_root()
    out = []
    for rel in targets:
        out += lint_file(os.path.join(root, rel), rel)
    return out
