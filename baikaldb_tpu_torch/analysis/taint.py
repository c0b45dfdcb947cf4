"""Device-value taint analysis (the core of HOSTSYNC), for eager torch.

A lightweight intra-function dataflow pass over the AST: tensors produced
by ``torch.*`` calls and tensor methods, ``.data`` / ``.validity`` /
``.sel`` attribute reads, and ``sel_mask()`` / ``valid_mask()`` /
``live_count()`` method calls are *device values* (CUDA tensors on the
card).  Host metadata is not: ``.shape``, ``.dtype``, ``.device``,
``.numel()``, ``.dim()``, ``len()``.  Taint propagates through arithmetic,
comparisons, subscripts and helper calls; sinks are the places a device
value crosses back to the host, each a blocking device->host read on the
card:

- ``int(x)`` / ``float(x)`` / ``bool(x)`` on a device value       -> HOSTSYNC
- ``np.asarray(x)`` / any ``np.*`` call on a device value         -> HOSTSYNC
- ``x.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
  ``.to("cpu")``, ``torch.equal`` / ``allclose``                  -> HOSTSYNC
- ``if`` / ``while`` / ternary / ``not`` / ``and`` / ``or`` on a
  device value (the tensor's ``__bool__``)                        -> HOSTSYNC
- iterating a tensor (one read per element)                       -> HOSTSYNC
- in the hot modules: ``nonzero`` / ``argwhere`` / ``unique`` /
  ``masked_select`` / one-argument ``where`` and boolean-mask
  subscripts (a data-dependent output shape: the size is read
  back before the output is allocated), and an explicit
  ``torch.cuda.synchronize`` / ``.synchronize()``                 -> HOSTSYNC

``host_read(x)`` (analysis/runtime.py) is the sanctioned spelling of a
read that is there by design: it is never a sink, and what it returns is
host data.  The pass is deliberately conservative-but-quiet: taint starts
only from the explicit device sources above, so host-side planner/catalog
code stays silent without per-file configuration.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass


# attributes that read host metadata off tensors / device containers
HOST_ATTRS = {
    "dtype", "shape", "ndim", "size", "ltype", "names", "name", "columns",
    "num_rows", "live_prefix", "dictionary", "values", "kind", "at",
    "device", "is_cuda", "layout", "requires_grad", "itemsize", "nbytes",
    "is_sparse", "is_quantized", "is_meta",
}
# engine attributes that ARE device tensors (column/batch.py containers)
DEVICE_ATTRS = {"data", "validity", "sel"}
# engine methods returning device values
DEVICE_METHODS = {"sel_mask", "valid_mask", "live_count"}
# tensor methods returning HOST metadata (never a read of the data)
_HOST_METHODS = {
    "numel", "dim", "size", "element_size", "stride", "is_contiguous",
    "data_ptr", "get_device", "is_floating_point", "is_complex",
    "nelement", "ndimension", "storage_offset", "is_pinned", "is_signed",
    "untyped_storage",
}
# tensor methods that read the data back to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "equal", "allclose"}
# ops whose output shape depends on the data (hot modules: a host read)
_DDSHAPE_FNS = {"nonzero", "argwhere", "unique", "unique_consecutive",
                "masked_select"}
# torch functions returning a host value computed from tensor data
_TORCH_SYNC_FNS = {"equal", "allclose", "is_nonzero"}
# torch functions returning HOST metadata / objects (not device values)
_TORCH_HOST_FNS = {
    "device", "dtype", "is_tensor", "is_storage", "iinfo", "finfo",
    "get_default_dtype", "set_default_dtype", "promote_types",
    "result_type", "can_cast", "is_floating_point", "is_complex", "numel",
    "Size", "no_grad", "inference_mode", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "manual_seed", "Generator", "get_num_threads",
    "set_num_threads", "compile", "use_deterministic_algorithms",
    "set_printoptions", "typename", "is_inference_mode_enabled",
    "from_numpy",           # a CPU tensor over host memory: no device yet
}
# torch namespaces that hold no tensor ops (streams, events, profiler,
# process groups, build info): their calls return host objects
_TORCH_HOST_ROOTS = ("torch.cuda.", "torch.backends.", "torch.utils.",
                     "torch.profiler.", "torch.distributed.",
                     "torch.library.", "torch.autograd.", "torch.jit.",
                     "torch.testing.", "torch.version.",
                     "torch.multiprocessing.", "torch._C.")
# engine methods that build device-value containers even off a host object
# (store/table handles): the result's .data/.sel re-taint downstream
_CONTAINER_METHODS = {"device_table_batch", "from_arrow", "gather",
                      "and_sel", "rename"}
# engine constructors: results are device-value CONTAINERS, not tensors
_CONTAINER_CTORS = {"ColumnBatch", "Column", "dreplace", "replace"}


@dataclass(frozen=True)
class T:
    """Taint value: ``array`` = is (or may be) a device tensor;
    ``container`` = host object that may hold device tensors (ColumnBatch,
    tuple of tensors); ``boolish`` = tensor known boolean-valued (mask)."""
    array: bool = False
    container: bool = False
    boolish: bool = False

    @property
    def tainted(self) -> bool:
        return self.array or self.container

    def __or__(self, other: "T") -> "T":
        return T(self.array or other.array,
                 self.container or other.container,
                 self.boolish or other.boolish)


UNT = T()
ARR = T(array=True)
BOOLARR = T(array=True, boolish=True)
CONT = T(container=True)


# return annotations of a host scalar: a same-module helper declared so
# (``def _kernel_route(...) -> bool``) returns no device value
_HOST_RETURNS = {"bool", "int", "float", "str"}


class ModuleIndex:
    """Alias table for one file: resolves dotted call targets through
    ``import``/``from`` aliases (collected file-wide, including imports
    inside function bodies), and the file's functions that return a host
    scalar by their annotation."""

    def __init__(self, tree: ast.AST):
        self.alias: dict[str, str] = {}
        self.host_fns: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and isinstance(node.returns, ast.Name) \
                    and node.returns.id in _HOST_RETURNS:
                self.host_fns.add(node.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.alias[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.alias.setdefault(root, root)
            elif isinstance(node, ast.ImportFrom):
                mod = ("." * node.level) + (node.module or "")
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.alias[a.asname or a.name] = f"{mod}.{a.name}"

    def resolve(self, expr: ast.expr) -> str | None:
        """Dotted path of a Name/Attribute chain with the root alias
        expanded (``F.pad`` -> ``torch.nn.functional.pad``), else None."""
        parts: list[str] = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if not isinstance(expr, ast.Name):
            return None
        root = self.alias.get(expr.id, expr.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def is_module_alias(self, name: str) -> bool:
        resolved = self.alias.get(name)
        return resolved is not None and not resolved.startswith(".") \
            and "." not in name


def param_taint(arg: ast.arg) -> T:
    """Initial taint of a parameter, from its annotation: engine containers
    taint as CONT (their ``.data`` etc. re-taints), tensors as ARR,
    everything else starts clean (host scalars/strings dominate)."""
    if arg.annotation is None:
        return UNT
    try:
        ann = ast.unparse(arg.annotation)
    except Exception:
        return UNT
    if "ColumnBatch" in ann or ann.strip() in ("Column", "Optional[Column]"):
        return CONT
    # torch tensors only: np.ndarray / pa.Array annotations are HOST data
    if "Tensor" in ann:
        return ARR
    return UNT


def merge_env(a: dict[str, T], b: dict[str, T]) -> dict[str, T]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, UNT) | v
    return out


def _is_host_read(path: str | None) -> bool:
    return path is not None and path.rsplit(".", 1)[-1] == "host_read"


def _to_cpu(e: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    cands = list(e.args[:1]) + [kw.value for kw in e.keywords
                                if kw.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Call) and c.args:
            c = c.args[0]
        if isinstance(c, ast.Constant) and c.value == "cpu":
            return True
    return False


class FunctionTaint:
    """Run the taint pass over one function body, reporting sinks through
    ``report(rule, node, msg)``.  Nested defs/lambdas/classes are analyzed
    inline with the enclosing environment as closure state.  ``hot``: the
    function lives in a hot module, where data-dependent shapes and
    explicit synchronizes are sinks too."""

    def __init__(self, fnode, modindex: ModuleIndex, hot: bool, report,
                 closure: dict[str, T] | None = None):
        self.f = fnode
        self.mi = modindex
        self.hot = hot
        self.report = report
        self.env: dict[str, T] = dict(closure or {})
        a = fnode.args
        for arg in [*a.posonlyargs, *a.args, *a.kwonlyargs,
                    *( [a.vararg] if a.vararg else []),
                    *( [a.kwarg] if a.kwarg else [])]:
            self.env[arg.arg] = param_taint(arg)

    def run(self) -> None:
        self.exec_body(self.f.body)

    def sync(self, node, what: str) -> None:
        self.report("HOSTSYNC", node,
                    f"{what}: blocking device->host read on the card; "
                    "keep it on device or spell it host_read(...)")

    # ---- statements -------------------------------------------------------

    def exec_body(self, stmts) -> None:
        for s in stmts:
            self.exec_stmt(s)

    def exec_stmt(self, s) -> None:  # noqa: C901 — flat dispatch
        if isinstance(s, ast.Assign):
            t = self.eval(s.value)
            for tgt in s.targets:
                self.assign(tgt, t)
        elif isinstance(s, ast.AugAssign):
            t = self.eval(s.value) | self.eval_target_load(s.target)
            self.assign(s.target, t)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.assign(s.target, self.eval(s.value))
        elif isinstance(s, ast.Expr):
            self.eval(s.value)
        elif isinstance(s, ast.If):
            self.branch_test(s.test)
            e0 = dict(self.env)
            self.exec_body(s.body)
            e1, self.env = self.env, dict(e0)
            self.exec_body(s.orelse)
            self.env = merge_env(e1, self.env)
        elif isinstance(s, ast.While):
            self.branch_test(s.test)
            self.loop_body(s.body)
            self.exec_body(s.orelse)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            it = self.eval(s.iter)
            if it.array:
                self.sync(s.iter, "python loop over a tensor (one read "
                          "per element)")
            elem = CONT if it.container else (ARR if it.array else UNT)
            self.assign(s.target, elem)
            self.loop_body(s.body)
            self.exec_body(s.orelse)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                t = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.assign(item.optional_vars, t)
            self.exec_body(s.body)
        elif isinstance(s, ast.Try):
            self.exec_body(s.body)
            base = dict(self.env)
            for h in s.handlers:
                self.env = dict(base)
                self.exec_body(h.body)
                base = merge_env(base, self.env)
            self.env = base
            self.exec_body(s.orelse)
            self.exec_body(s.finalbody)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                self.eval(s.value)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.eval(s.exc)
        elif isinstance(s, ast.Assert):
            self.eval(s.test)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: hot-ness inherits (compile_plan's closures)
            FunctionTaint(s, self.mi, self.hot, self.report,
                          closure=dict(self.env)).run()
            self.env[s.name] = UNT
        elif isinstance(s, ast.ClassDef):
            for b in s.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    FunctionTaint(b, self.mi, self.hot, self.report,
                                  closure=dict(self.env)).run()
            self.env[s.name] = UNT
        elif isinstance(s, ast.Delete):
            for tgt in s.targets:
                if isinstance(tgt, ast.Name):
                    self.env.pop(tgt.id, None)
        # Pass/Break/Continue/Import/Global: no dataflow

    def loop_body(self, body) -> None:
        """Two passes approximate the loop fixpoint (taint only grows)."""
        snapshot = dict(self.env)
        self.exec_body(body)
        self.env = merge_env(snapshot, self.env)
        self.exec_body(body)

    def branch_test(self, test) -> None:
        t = self.eval(test)
        if t.array:
            self.sync(test, "python branch on a tensor (its __bool__)")

    # ---- assignment targets ----------------------------------------------

    def assign(self, tgt, t: T) -> None:
        if isinstance(tgt, ast.Name):
            self.env[tgt.id] = t
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self.assign(el, t)
        elif isinstance(tgt, ast.Starred):
            self.assign(tgt.value, t)
        elif isinstance(tgt, ast.Attribute):
            self.eval(tgt.value)
        elif isinstance(tgt, ast.Subscript):
            self.eval(tgt.slice)
            if isinstance(tgt.value, ast.Name) and t.tainted:
                base = self.env.get(tgt.value.id, UNT)
                self.env[tgt.value.id] = base | CONT

    def eval_target_load(self, tgt) -> T:
        if isinstance(tgt, (ast.Name, ast.Attribute, ast.Subscript)):
            return self.eval(tgt)
        return UNT

    # ---- expressions ------------------------------------------------------

    def eval(self, e) -> T:  # noqa: C901 — flat dispatch
        if e is None or isinstance(e, ast.Constant):
            return UNT
        if isinstance(e, ast.Name):
            return self.env.get(e.id, UNT)
        if isinstance(e, ast.Attribute):
            if isinstance(e.value, ast.Name) and \
                    self.mi.is_module_alias(e.value.id):
                return UNT          # torch.int32, np.float64, constants
            vt = self.eval(e.value)
            # .data/.validity/.sel are tensors only on engine column
            # containers — gate on owner taint (or hot scope, where any
            # unannotated container flows through) so arrow RegionData.data
            # / raft LogEntry.data stay host
            if e.attr in DEVICE_ATTRS and (self.hot or vt.tainted):
                return ARR
            if e.attr in HOST_ATTRS:
                return UNT
            if vt.tainted:
                return T(vt.array, vt.container, False)
            return UNT
        if isinstance(e, ast.Call):
            return self.eval_call(e)
        if isinstance(e, ast.BinOp):
            lt, rt = self.eval(e.left), self.eval(e.right)
            return ARR if (lt.array or rt.array) else UNT
        if isinstance(e, ast.UnaryOp):
            t = self.eval(e.operand)
            if isinstance(e.op, ast.Not) and t.array:
                self.sync(e, "python `not` on a tensor (use ~ / "
                          "torch.logical_not)")
                return UNT
            return T(t.array, False, t.boolish) if t.array else UNT
        if isinstance(e, ast.BoolOp):
            ts = [self.eval(v) for v in e.values]
            if any(t.array for t in ts):
                self.sync(e, "python and/or on a tensor (use & / | or "
                          "torch.where)")
                return BOOLARR
            return UNT
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                self.eval(e.left)
                for c in e.comparators:
                    self.eval(c)
                return UNT
            ts = [self.eval(e.left)] + [self.eval(c) for c in e.comparators]
            return BOOLARR if any(t.array for t in ts) else UNT
        if isinstance(e, ast.IfExp):
            self.branch_test(e.test)
            return self.eval(e.body) | self.eval(e.orelse)
        if isinstance(e, ast.Subscript):
            vt = self.eval(e.value)
            st = self.eval(e.slice)
            if st.array and st.boolish and vt.array and self.hot:
                self.sync(e, "boolean-mask subscript (a data-dependent "
                          "output shape: use torch.where / a sel mask)")
            if vt.array or vt.container:
                return ARR
            return ARR if st.array else UNT
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            ts = [self.eval(el) for el in e.elts]
            return CONT if any(t.tainted for t in ts) else UNT
        if isinstance(e, ast.Dict):
            ts = [self.eval(v) for v in (*e.keys, *e.values) if v is not None]
            return CONT if any(t.tainted for t in ts) else UNT
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            return self.eval_comp(e)
        if isinstance(e, ast.Lambda):
            sub = FunctionTaint(_LambdaShim(e), self.mi, self.hot,
                                self.report, closure=dict(self.env))
            sub.eval(e.body)
            return UNT
        if isinstance(e, ast.JoinedStr):
            for v in e.values:
                if isinstance(v, ast.FormattedValue):
                    self.eval(v.value)
            return UNT
        if isinstance(e, ast.FormattedValue):
            self.eval(e.value)
            return UNT
        if isinstance(e, ast.Starred):
            return self.eval(e.value)
        if isinstance(e, ast.NamedExpr):
            t = self.eval(e.value)
            self.assign(e.target, t)
            return t
        if isinstance(e, (ast.Await, ast.Yield, ast.YieldFrom)):
            return self.eval(e.value) if e.value is not None else UNT
        if isinstance(e, ast.Slice):
            for part in (e.lower, e.upper, e.step):
                if part is not None:
                    self.eval(part)
            return UNT
        return UNT

    def eval_comp(self, e) -> T:
        saved = dict(self.env)
        elem_t = UNT
        for gen in e.generators:
            it = self.eval(gen.iter)
            if it.array:
                self.sync(gen.iter, "comprehension over a tensor (one "
                          "read per element)")
            self.assign(gen.target,
                        CONT if it.container else (ARR if it.array else UNT))
            for cond in gen.ifs:
                self.eval(cond)
        if isinstance(e, ast.DictComp):
            elem_t = self.eval(e.key) | self.eval(e.value)
        else:
            elem_t = self.eval(e.elt)
        self.env = saved
        return CONT if elem_t.tainted else UNT

    # ---- calls ------------------------------------------------------------

    def call_args(self, e: ast.Call) -> T:
        t = UNT
        for a in e.args:
            t = t | self.eval(a)
        for kw in e.keywords:
            t = t | self.eval(kw.value)
        return t

    def eval_call(self, e: ast.Call) -> T:  # noqa: C901
        path = self.mi.resolve(e.func)

        # the sanctioned read: its argument crosses to the host by design;
        # the two-argument form runs a data-dependent-shape op (its size
        # read) and returns that op's device result
        if _is_host_read(path):
            self.call_args(e)
            return ARR if len(e.args) > 1 else UNT
        # builtins that force a host value out of a device scalar
        if path in ("int", "float", "bool", "complex"):
            t = self.call_args(e)
            if t.array:
                self.sync(e, f"{path}() on a tensor")
            return UNT
        if path in ("len", "str", "repr", "format", "hash", "id", "type",
                    "isinstance", "issubclass", "print", "getattr", "hasattr",
                    "sorted", "range", "zip", "enumerate", "iter", "next",
                    "abs", "min", "max", "sum"):
            at = self.call_args(e)
            if path in ("abs", "min", "max", "sum") and at.array:
                return ARR
            return UNT

        if path is not None:
            root = path.split(".")[0]
            if root == "numpy":
                t = self.call_args(e)
                if t.array:
                    self.sync(e, f"{ast.unparse(e.func)}() on a tensor "
                              "materializes it on the host")
                return UNT
            if root == "torch":
                self.call_args(e)
                fn = path.split(".")[-1]
                if path.startswith(_TORCH_HOST_ROOTS):
                    if self.hot and fn == "synchronize":
                        self.sync(e, "torch.cuda.synchronize in a hot "
                                  "module")
                    return UNT
                if fn in _TORCH_HOST_FNS:
                    return UNT
                if fn in _TORCH_SYNC_FNS:
                    self.sync(e, f"torch.{fn}() returns a host value "
                              "computed from tensors")
                    return UNT
                self._ddshape(e, fn)
                return ARR
            last = path.split(".")[-1]
            if last in _CONTAINER_CTORS:
                self.call_args(e)
                return CONT

        # method calls: obj.meth(...)
        if isinstance(e.func, ast.Attribute):
            owner_t = self.eval(e.func.value)
            meth = e.func.attr
            args_t = self.call_args(e)
            if meth in DEVICE_METHODS:
                return ARR
            if meth in _CONTAINER_METHODS:
                return CONT
            if meth in ("to", "cuda") and not _to_cpu(e):
                return ARR          # an upload (or a move between cards)
            if owner_t.array:
                if meth in _HOST_METHODS:
                    return UNT
                if meth in _SYNC_METHODS or (meth == "to" and _to_cpu(e)):
                    self.sync(e, f".{meth}() of a tensor")
                    return UNT
                if meth == "synchronize":
                    if self.hot:
                        self.sync(e, ".synchronize() in a hot module")
                    return UNT
                self._ddshape(e, meth, method=True)
                return ARR
            if meth == "synchronize" and self.hot:
                self.sync(e, ".synchronize() in a hot module")
                return UNT
            if owner_t.container:
                return CONT
            return ARR if args_t.array else UNT

        # plain / unresolved calls: conservative propagation through helpers
        args_t = self.call_args(e)
        if isinstance(e.func, ast.Name) and e.func.id in self.mi.host_fns:
            return UNT
        self.eval(e.func)
        return ARR if args_t.array else (CONT if args_t.container else UNT)

    def _ddshape(self, e: ast.Call, fn: str, method: bool = False) -> None:
        if not self.hot:
            return
        nargs = len(e.args) + (1 if method else 0)
        if fn in _DDSHAPE_FNS or (fn == "where" and nargs == 1):
            self.sync(e, f"{fn}(): a data-dependent output shape (the "
                      "size is read back before the output exists)")


class _LambdaShim:
    """Adapter so FunctionTaint can bind a Lambda's params."""

    def __init__(self, lam: ast.Lambda):
        self.args = lam.args
        self.body = []
        self.name = "<lambda>"
