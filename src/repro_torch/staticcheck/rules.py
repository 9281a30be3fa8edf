"""The port's rule registry: the reference's RS001-RS005
(``repro/staticcheck/rules.py``), with RS005 rewritten for torch.

  RS001  bare ``assert`` guarding a runtime invariant in non-test code —
         stripped by ``python -O``, so the invariant silently vanishes;
         raise instead.
  RS002  ``np.empty`` for slot/index buffers: unwritten slots are garbage
         a later gather will happily read.
  RS003  truthiness on int-or-None config fields (``max_k`` etc.):
         ``max_k or n`` coerces the valid value 0 into "unbounded";
         compare against None.
  RS004  ``os.environ["XLA_..."] = ...`` overwrite: clobbers flags the
         caller already set; append to the existing value.
  RS005  a host<->device conversion inside a registered hot function of the
         mining path: ``.cpu()``, ``.numpy()``, ``.item()`` or ``.tolist()``
         of a tensor, ``int()``/``float()``/``np.asarray()`` of a tensor, or
         ``torch.as_tensor``/``torch.tensor``/``torch.from_numpy`` of host
         state without an explicit ``.to(device)`` (or ``device=``).  Each
         is a wait for the card (or an implicit copy); the ones the path
         must make are declared syncs of Layer 3 (``shapes.SYNC_BUDGET``).

Suppression: append ``# staticcheck: disable=RSnnn`` (comma-separate for
several ids) to the flagged line or the line above it, next to a comment
that justifies why the rule does not apply.  An RS005 suppression also
names the Layer-3 sync it is, ``sync=<site>`` (a key of
``shapes.SYNC_BUDGET``); the explicit uploads that the budget declares
carry the same ``# staticcheck: sync=<site>`` marker without a
suppression, since RS005 does not flag them.

Pure stdlib: importing this module imports neither torch nor numpy.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional, Set, Union

from .report import Finding

__all__ = ["Rule", "RULES", "HOT_PATHS", "rule_ids", "LintContext",
           "INT_OR_NONE_CONFIG_FIELDS", "HOT_PATH_PRAGMA"]

# module-path suffix -> hot function names ("*" = every function in the
# file): what a warm mine level and a stream slide run (the Layer-3
# audit's region), the mesh engines' counterparts among them.  RS005 keeps
# them free of undeclared host<->device conversions.
HOT_PATHS: Dict[str, Union[str, Set[str]]] = {
    "repro_torch/core/engine.py": {
        "expand", "_compact", "_take", "_survivors", "_slice_survivors",
        "_rank_survivors", "_assemble", "_reduced_survivors"},
    "repro_torch/core/triangular.py": {"cooccurrence_counts"},
    "repro_torch/core/eclat.py": {"run_bottom_up"},
    "repro_torch/device.py": {"words_from_numpy"},
    "repro_torch/streaming/window.py": {"push", "_write_device"},
    "repro_torch/streaming/miner.py": {"push", "mine_window", "advance",
                                       "_block_counts"},
    # the serving read path answers from host snapshots by design: any
    # device conversion at all is a regression
    "repro_torch/serving/snapshot.py": "*",
    "repro_torch/serving/stream_query.py": "*",
}

# files outside the registry can declare themselves hot (the fixtures do)
HOT_PATH_PRAGMA = "# staticcheck: hot-path"

# config fields that are int-or-None where 0 is a *valid int*, not "unset"
INT_OR_NONE_CONFIG_FIELDS = {
    "max_k", "cand_chunk", "block_w", "top_k", "keep_versions",
    "kill_after", "checkpoint_every", "max_batches",
}

_NP_NAMES = {"np", "numpy"}
_INT_DTYPE_ATTRS = {"int8", "int16", "int32", "int64", "uint8", "uint16",
                    "uint32", "uint64", "intp", "int_", "longlong"}
# always a read of a tensor's values on the host
_TENSOR_READS = {"cpu", "numpy"}
# a read of values on the host when the receiver is a tensor (numpy arrays
# have them too)
_VALUE_READS = {"item", "tolist"}
# builtins that read a tensor's value
_SCALAR_READS = {"int", "float"}
# host state into a tensor: fine only with an explicit move to a device
_HOST_TENSORS = {"as_tensor", "tensor", "from_numpy"}
# tensor methods and attributes whose result is host metadata, not a tensor
_HOST_METHODS = {"numel", "size", "dim", "element_size", "stride",
                 "data_ptr", "is_contiguous", "nelement", "get_device",
                 "item", "tolist", "numpy"}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout"}
_TORCH_HOST_CALLS = {"device", "Size", "dtype", "Generator", "is_tensor",
                     "get_default_dtype"}


@dataclasses.dataclass
class LintContext:
    """Everything one rule pass needs about one file."""

    path: str                       # repo-relative, forward slashes
    tree: ast.AST
    lines: List[str]                # raw source lines (1-indexed via [i-1])
    suppressed: Dict[int, Set[str]]  # line -> rule ids disabled there
    is_test: bool                   # tests/ or test_*.py / conftest.py
    hot_functions: Union[str, Set[str], None]   # "*" | set | None
    func_of: Dict[int, str]         # id(node) -> innermost enclosing def

    def enclosing(self, node: ast.AST) -> Optional[str]:
        return self.func_of.get(id(node))

    def in_hot_function(self, node: ast.AST) -> Optional[str]:
        fn = self.enclosing(node)
        if self.hot_functions == "*":
            return fn or "<module>"
        if fn is not None and self.hot_functions and \
                fn in self.hot_functions:
            return fn
        return None

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        for ln in (line, line - 1):
            if rule_id in self.suppressed.get(ln, set()):
                return True
        return False


@dataclasses.dataclass
class Rule:
    id: str
    title: str
    rationale: str
    check: Callable[[LintContext], List[Finding]]


def _finding(ctx: LintContext, rule_id: str, node: ast.AST,
             message: str) -> List[Finding]:
    line = getattr(node, "lineno", 0)
    if ctx.is_suppressed(rule_id, line):
        return []
    return [Finding(rule=rule_id, path=ctx.path, line=line, message=message)]


def _dotted(node: ast.AST) -> str:
    """'os.environ.get' for nested Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# -- RS001 ------------------------------------------------------------------

def _check_rs001(ctx: LintContext) -> List[Finding]:
    if ctx.is_test:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assert):
            out += _finding(
                ctx, "RS001", node,
                "bare `assert` guards a runtime invariant but is stripped "
                "under `python -O`; raise RuntimeError/ValueError with a "
                "diagnostic message instead")
    return out


# -- RS002 ------------------------------------------------------------------

def _is_int_dtype_expr(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Attribute) and node.attr in _INT_DTYPE_ATTRS:
        return True
    if isinstance(node, ast.Name) and node.id in _INT_DTYPE_ATTRS:
        return True
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.lstrip("u").lstrip("int").isdigit() or \
            node.value in _INT_DTYPE_ATTRS
    return False


def _check_rs002(ctx: LintContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "empty"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in _NP_NAMES):
            continue
        if node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == 0:
            continue  # zero-length: nothing to leave uninitialized
        dtype = node.args[1] if len(node.args) > 1 else None
        for kw in node.keywords:
            if kw.arg == "dtype":
                dtype = kw.value
        if not _is_int_dtype_expr(dtype):
            continue
        out += _finding(
            ctx, "RS002", node,
            "np.empty(...) integer slot/index buffer: any slot the fill "
            "loop misses is garbage that a later gather reads as a valid "
            "index (silently wrong supports); use np.zeros, or suppress "
            "with a justification that every slot is provably written")
    return out


# -- RS003 ------------------------------------------------------------------

def _truthiness_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name) and node.id in INT_OR_NONE_CONFIG_FIELDS:
        return node.id
    if isinstance(node, ast.Attribute) and \
            node.attr in INT_OR_NONE_CONFIG_FIELDS:
        return node.attr
    return None


def _check_rs003(ctx: LintContext) -> List[Finding]:
    # dedup by source position: a BoolOp inside an if-test is reachable
    # both as the test and as a walked BoolOp node
    hits: Dict[tuple, ast.AST] = {}

    def mark(node: ast.AST):
        name = _truthiness_name(node)
        if name is not None:
            hits[(node.lineno, node.col_offset)] = node

    def mark_test(test: ast.AST):
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            mark_test(test.operand)
        elif isinstance(test, ast.BoolOp):
            for v in test.values:
                mark_test(v)
        else:
            mark(test)

    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            mark_test(node.test)
        elif isinstance(node, ast.BoolOp):
            # `max_k or default`: every non-last operand is truthiness-tested
            for v in node.values[:-1]:
                mark(v)
    out: List[Finding] = []
    for _, node in sorted(hits.items()):
        name = _truthiness_name(node)
        out.extend(_finding(
            ctx, "RS003", node,
            f"truthiness on int-or-None field `{name}` treats the valid "
            f"value 0 as unset (`{name}=0` silently becomes unbounded); "
            f"compare `is None` / `is not None` explicitly"))
    return out


# -- RS004 ------------------------------------------------------------------

def _environ_key(node: ast.AST) -> Optional[str]:
    """The constant key of an ``os.environ[...]`` subscript, else None."""
    if not isinstance(node, ast.Subscript):
        return None
    if _dotted(node.value) not in ("os.environ", "environ"):
        return None
    sl = node.slice
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
        return sl.value
    return None


def _reads_same_key(rhs: ast.AST, key: str) -> bool:
    for sub in ast.walk(rhs):
        if _environ_key(sub) == key:
            return True
        if isinstance(sub, ast.Call) and \
                _dotted(sub.func) in ("os.environ.get", "environ.get") and \
                sub.args and isinstance(sub.args[0], ast.Constant) and \
                sub.args[0].value == key:
            return True
    return False


def _check_rs004(ctx: LintContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            key = _environ_key(tgt)
            if key is None or not key.startswith("XLA"):
                continue
            if _reads_same_key(node.value, key):
                continue
            out += _finding(
                ctx, "RS004", node,
                f"os.environ[{key!r}] overwritten — any value the caller "
                f"already exported (device counts, dump flags) is silently "
                f"clobbered; append: os.environ.get({key!r}, '') + ' ...'")
    return out


# -- RS005 ------------------------------------------------------------------

class _Kinds:
    """What each local name of one function holds, as far as the source
    shows: ``"tensor"`` (a parameter annotated ``torch.Tensor``, or bound to
    a torch call or to an expression over tensors), ``"numpy"`` (annotated
    ``np.ndarray`` or bound to an ``np.*`` call), else unknown."""

    def __init__(self, fn: ast.AST):
        self.names: Dict[str, str] = {}
        args = fn.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            ann = _dotted(a.annotation) if a.annotation is not None else ""
            if ann.split(".")[-1] == "Tensor":
                self.names[a.arg] = "tensor"
            elif ann in ("np.ndarray", "numpy.ndarray"):
                self.names[a.arg] = "numpy"
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))
                   and n.value is not None]
        changed = True
        while changed:          # to a fixed point: a kind flows through names
            changed = False
            for node in assigns:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    pairs = [(tgt, node.value)]
                    if isinstance(tgt, ast.Tuple) and \
                            isinstance(node.value, ast.Tuple) and \
                            len(tgt.elts) == len(node.value.elts):
                        pairs = list(zip(tgt.elts, node.value.elts))
                    for t, v in pairs:
                        kind = self.of(v)
                        if isinstance(t, ast.Name) and kind and \
                                self.names.get(t.id) != kind:
                            self.names[t.id] = kind
                            changed = True

    def of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return self.names.get(node.id)
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            head = dotted.split(".")[0]
            if head == "torch":
                last = dotted.split(".")[-1]
                if dotted.startswith(("torch.cuda.", "torch.distributed.")) \
                        or last in _TORCH_HOST_CALLS:
                    return None
                return "tensor"
            if head in _NP_NAMES:
                return "numpy"
            if isinstance(node.func, ast.Attribute):
                recv = self.of(node.func.value)
                if recv == "tensor" and node.func.attr not in _HOST_METHODS:
                    return "tensor"
                if recv == "numpy" and node.func.attr not in ("tolist", "item"):
                    return "numpy"
            return None
        if isinstance(node, ast.Subscript):
            return self.of(node.value)
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return None
            return self.of(node.value)
        if isinstance(node, ast.BinOp):
            kinds = {self.of(node.left), self.of(node.right)}
            return "tensor" if "tensor" in kinds else (
                "numpy" if "numpy" in kinds else None)
        if isinstance(node, ast.UnaryOp):
            return self.of(node.operand)
        if isinstance(node, ast.IfExp):
            return self.of(node.body) or self.of(node.orelse)
        return None


def _functions(tree: ast.AST):
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _check_rs005(ctx: LintContext) -> List[Finding]:
    if not ctx.hot_functions:
        return []
    parent: Dict[int, ast.AST] = {}
    for node in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(node):
            parent[id(child)] = node
    kinds = {id(fn): _Kinds(fn) for fn in _functions(ctx.tree)}

    def kinds_of(node: ast.AST) -> Optional[_Kinds]:
        while node is not None and id(node) not in kinds:
            node = parent.get(id(node))
        return None if node is None else kinds[id(node)]
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = ctx.in_hot_function(node)
        if fn is None:
            continue
        k = kinds_of(node)
        kind_of = k.of if k is not None else (lambda n: None)
        what = None
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv = node.func.value
            if attr in _TENSOR_READS and not node.args:
                # `.cpu().numpy()` is one read: the copy's
                if not (attr == "numpy" and isinstance(recv, ast.Call)
                        and isinstance(recv.func, ast.Attribute)
                        and recv.func.attr == "cpu"):
                    what = f"`.{attr}()`"
            elif attr in _VALUE_READS and not node.args and \
                    kind_of(recv) != "numpy":
                what = f"`.{attr}()`"
            elif _dotted(recv) in _NP_NAMES and attr in ("asarray", "array") \
                    and node.args and kind_of(node.args[0]) == "tensor":
                what = f"`np.{attr}` of a tensor"
            elif _dotted(recv) == "torch" and attr in _HOST_TENSORS:
                up = parent.get(id(node))
                moved = (isinstance(up, ast.Attribute) and up.attr == "to"
                         and isinstance(parent.get(id(up)), ast.Call))
                if not moved and not any(kw.arg == "device"
                                         for kw in node.keywords):
                    what = (f"`torch.{attr}` of host state without an "
                            f"explicit `.to(device)`")
        elif isinstance(node.func, ast.Name) and \
                node.func.id in _SCALAR_READS and len(node.args) == 1 and \
                kind_of(node.args[0]) == "tensor":
            what = f"`{node.func.id}()` of a tensor"
        if what is None:
            continue
        out += _finding(
            ctx, "RS005", node,
            f"host<->device conversion {what} in hot path `{fn}` — a wait "
            f"for the card the steady-state level/slide loop did not "
            f"declare; move data only through the declared syncs "
            f"(staticcheck.shapes.SYNC_BUDGET, the Layer-3 contract)")
    return out


RULES: List[Rule] = [
    Rule("RS001", "bare assert guarding a runtime invariant",
         "python -O strips asserts",
         _check_rs001),
    Rule("RS002", "np.empty for integer slot/index buffers",
         "unwritten slots are garbage later gathers read",
         _check_rs002),
    Rule("RS003", "truthiness on int-or-None config fields",
         "`max_k or n` coerces the valid 0 into unbounded",
         _check_rs003),
    Rule("RS004", "XLA env var overwritten instead of appended",
         "clobbers flags the caller exported",
         _check_rs004),
    Rule("RS005", "undeclared host<->device conversion in a hot path",
         "every wait for the card in a level or slide is a declared sync",
         _check_rs005),
]


def rule_ids() -> List[str]:
    return [r.id for r in RULES]
