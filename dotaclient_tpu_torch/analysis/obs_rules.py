"""OBS rules: static drift guards for the observability + config
contracts.

The runtime drift guard (tests/test_obs.py::test_emitted_scalars_are_
registered) catches an unregistered scalar only when a real learner
window emits it; the k8s manifests are not executed by any test at all.
These rules close both gaps at lint time:

OBS001 (error) — every scalar name passed STRING-LITERALLY to
``MetricsLogger.log`` (dict-literal keys, and ``scalars["name"] = ...``
subscript stores on the dict variable later passed to ``.log``) must
exist in ``obs/registry.py`` (SCALARS exact names or PREFIXES
families). Dynamic keys (f-strings, loop variables) are the runtime
guard's job and are skipped here.

OBS002 (error) — every ``--flag`` referenced in ``k8s/*.yaml`` must
exist in the flag namespace of the binary that manifest runs
(``config.py`` dataclass fields flattened the way ``add_flags`` does,
or the broker's argparse). The binary is identified from the
manifest's ``-m dotaclient_tpu...`` command line — the manifests name
the reference's binaries, each of which the port runs as its twin
``dotaclient_tpu_torch...`` with the same flags — and flags are scoped
to the enclosing yaml sequence item that mentions it (the container
block) — a sidecar container's own ``--config``-style flags in the
same manifest are some other program's namespace, not drift. Comment
lines are ignored.

The same rule also covers the ``scripts/`` bench/soak drivers: any
LIST LITERAL in a ``scripts/*.py`` file that names a known
``dotaclient_tpu_torch.<x>`` binary (the subprocess-argv idiom,
``[sys.executable, "-m", "dotaclient_tpu_torch.serve.server",
"--serve.port", ...]``) has its ``"--flag"`` string elements checked
against that binary's namespace. Scoping to the list literal keeps a
script's OWN argparse flags (self-reinvocation argv with no module
string) and prose mentions out of scope; flag lists composed in a
helper function and concatenated in (``+ _policy_flags(...)``) are a
known blind spot — the k8s manifests remain the deploy-surface source
of truth.

OBS003 (warning) — every leaf config field defined in ``config.py``
must be READ somewhere in the package (an ``.name`` attribute load
outside config.py). A defined-but-never-consumed flag is a lie in the
deploy surface: operators set it and nothing changes. Matching is by
attribute name, deliberately loose — a false "consumed" beats noisy
false positives; the satellite audit is the place to be strict.

Everything is AST/regex over source — no imports, no yaml dependency.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from dotaclient_tpu_torch.analysis.core import (
    Finding,
    ModuleUnit,
    RepoContext,
    Rule,
    register,
)

_FLAG_RE = re.compile(r"--([A-Za-z0-9_][A-Za-z0-9_.]*)")
_MODULE_RE = re.compile(r"dotaclient_tpu(?:_torch)?(?:\.[a-z_0-9]+)+")
_ITEM_RE = re.compile(r"^(\s*)-(\s|$)")


def _item_blocks(stripped: List[str]) -> List[Tuple[int, int, int]]:
    """(start, end, dash-indent) 0-based inclusive line ranges of every
    yaml sequence item (``- ...``). An item ends before the first
    non-blank line indented at or left of its dash — enough structure to
    scope a container block without a yaml dependency."""
    blocks: List[Tuple[int, int, int]] = []
    for i, ln in enumerate(stripped):
        m = _ITEM_RE.match(ln)
        if not m:
            continue
        indent = len(m.group(1))
        end = len(stripped) - 1
        for j in range(i + 1, len(stripped)):
            nxt = stripped[j]
            if not nxt.strip():
                continue
            if len(nxt) - len(nxt.lstrip(" ")) <= indent:
                end = j - 1
                break
        blocks.append((i, end, indent))
    return blocks

# the port's binary → root config dataclass in config.py ("argparse:<path>"
# = stdlib argparse binaries, flags parsed from their add_argument calls)
_BINARY_CONFIGS = {
    "dotaclient_tpu_torch.runtime.learner": "LearnerConfig",
    "dotaclient_tpu_torch.runtime.actor": "ActorConfig",
    "dotaclient_tpu_torch.runtime.selfplay": "ActorConfig",
    "dotaclient_tpu_torch.eval.evaluator": "EvalConfig",
    "dotaclient_tpu_torch.serve.server": "InferenceConfig",
    "dotaclient_tpu_torch.serve.handoff": "HandoffConfig",
    "dotaclient_tpu_torch.control.server": "ControlConfig",
    "dotaclient_tpu_torch.obs.fleetd": "FleetConfig",
    "dotaclient_tpu_torch.league.server": "LeagueConfig",
    "dotaclient_tpu_torch.transport.tcp_server": "argparse:transport/tcp_server.py",
    "dotaclient_tpu_torch.transport.fabric": "argparse:transport/fabric.py",
}


def binary_modules(text: str) -> List[str]:
    """Every binary module named in `text`, as the port's module: the
    k8s manifests name ``dotaclient_tpu.<x>``, whose twin
    ``dotaclient_tpu_torch.<x>`` takes the same flags."""
    out = []
    for mod in _MODULE_RE.findall(text):
        if not mod.startswith("dotaclient_tpu_torch."):
            mod = "dotaclient_tpu_torch" + mod[len("dotaclient_tpu"):]
        out.append(mod)
    return out


def _registry_names(ctx: RepoContext) -> Tuple[Set[str], Set[str]]:
    """parse_registry_names, once per lint run (OBS001 runs per module;
    re-parsing the registry per file is pure waste)."""
    cached = getattr(ctx, "_registry_names_cache", None)
    if cached is None:
        cached = ctx._registry_names_cache = parse_registry_names(
            ctx.registry_path, tree=ctx.ast_of(ctx.registry_path)
        )
    return cached


def parse_registry_names(
    registry_path: str, tree: Optional[ast.Module] = None
) -> Tuple[Set[str], Set[str]]:
    """(exact scalar names, family prefixes) from obs/registry.py — by
    AST, so linting never imports the package. Pass `tree` (the
    RepoContext.ast_of cache) to skip the re-parse."""
    if tree is None:
        with open(registry_path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=registry_path)
    scalars: Set[str] = set()
    prefixes: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        value = node.value
        if not isinstance(value, ast.Dict):
            continue
        for tgt in targets:
            name = getattr(tgt, "id", "")
            bucket = {"SCALARS": scalars, "PREFIXES": prefixes}.get(name)
            if bucket is None:
                continue
            for key in value.keys:
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    bucket.add(key.value)
    return scalars, prefixes


def _registered(name: str, scalars: Set[str], prefixes: Set[str]) -> bool:
    if name in scalars or name in ("step", "time"):
        return True
    return any(name.startswith(p) for p in prefixes)


def _head_registered(head: str, scalars: Set[str], prefixes: Set[str]) -> bool:
    """Can a dynamically-composed name starting with `head` still land
    inside the registry? True when the head sits inside a PREFIXES
    family (``fleet_ledger_`` under ``fleet_``), when a family starts
    with the head (``staging_`` composing into ``staging_pack_*``), or
    when an exact scalar starts with it (``ckpt_`` + a stats key =
    ``ckpt_save_ms``). Only a head that can NEVER reach a registered
    name is drift — this keeps the check sound without re-deriving
    every runtime tail."""
    if not head:
        return True  # f"{var}..." — nothing static to judge
    if any(head.startswith(p) or p.startswith(head) for p in prefixes):
        return True
    return any(s.startswith(head) for s in scalars)


def _key_violation(
    key: ast.AST, scalars: Set[str], prefixes: Set[str]
) -> Optional[Tuple[str, bool]]:
    """(display name, is_dynamic) when `key` names an unregistered
    scalar; None when registered or out of scope. Constant string keys
    are judged exactly; f-string keys by their constant head (the
    dynamically-composed family blind spot OBS001 used to document
    instead of checking). Keys with no static head stay the runtime
    drift guard's job."""
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        if not _registered(key.value, scalars, prefixes):
            return key.value, False
        return None
    if isinstance(key, ast.JoinedStr) and key.values:
        first = key.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            if not _head_registered(first.value, scalars, prefixes):
                return first.value + "…", True
    return None


@register
class UnregisteredScalar(Rule):
    id = "OBS001"
    severity = "error"
    doc = "scalar name logged to MetricsLogger but absent from obs/registry.py"

    def run(self, module: ModuleUnit, ctx: RepoContext) -> List[Finding]:
        if ctx.registry_path is None or not os.path.exists(ctx.registry_path):
            return []
        # the registry documents itself; MetricsLogger's own module holds
        # the logger, not emitters
        if module.relpath.endswith("obs/registry.py"):
            return []
        scalars, prefixes = _registry_names(ctx)
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            log_dict_vars: Set[str] = set()
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if not (isinstance(f, ast.Attribute) and f.attr == "log"):
                    continue
                if not self._is_metrics_receiver(f.value, fn, module):
                    continue
                if len(sub.args) < 2:
                    continue
                payload = sub.args[1]
                if isinstance(payload, ast.Dict):
                    for key in payload.keys:
                        bad = _key_violation(key, scalars, prefixes)
                        if bad:
                            findings.append(
                                self._finding(module, key, bad[0], fn, bad[1])
                            )
                elif isinstance(payload, ast.Name):
                    log_dict_vars.add(payload.id)
            if not log_dict_vars:
                continue
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Assign):
                    continue
                for tgt in sub.targets:
                    if (
                        isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id in log_dict_vars
                    ):
                        bad = _key_violation(tgt.slice, scalars, prefixes)
                        if bad:
                            findings.append(
                                self._finding(module, tgt, bad[0], fn, bad[1])
                            )
                    elif (
                        isinstance(tgt, ast.Name)
                        and tgt.id in log_dict_vars
                        and isinstance(sub.value, ast.Dict)
                    ):
                        # the dict-LITERAL initializer of the logged
                        # var: `scalars = {"name": ...}` then
                        # `metrics.log(step, scalars)`
                        for key in sub.value.keys:
                            bad = _key_violation(key, scalars, prefixes)
                            if bad:
                                findings.append(
                                    self._finding(module, key, bad[0], fn, bad[1])
                                )
        return findings

    @staticmethod
    def _is_metrics_receiver(recv: ast.expr, fn: ast.AST, module: ModuleUnit) -> bool:
        # self.metrics.log / metrics.log / <var bound to MetricsLogger()>
        if isinstance(recv, ast.Attribute) and recv.attr == "metrics":
            return True
        if isinstance(recv, ast.Name):
            if recv.id == "metrics":
                return True
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                    callee = sub.value.func
                    callee_name = (
                        callee.attr
                        if isinstance(callee, ast.Attribute)
                        else getattr(callee, "id", "")
                    )
                    if callee_name == "MetricsLogger" and any(
                        isinstance(t, ast.Name) and t.id == recv.id
                        for t in sub.targets
                    ):
                        return True
        return False

    def _finding(
        self, module: ModuleUnit, node: ast.AST, name: str, fn, dynamic: bool = False
    ) -> Finding:
        qual = module.qualname_at(node)
        if dynamic:
            msg = (
                f"dynamically-composed scalar head {name!r} is logged here "
                f"but no obs/registry.py PREFIXES family (or SCALARS name) "
                f"can contain it — dashboards select by name; register a "
                f"family for the head or rename"
            )
        else:
            msg = (
                f"scalar {name!r} is logged here but not registered in "
                f"obs/registry.py — dashboards select by name; add it to "
                f"SCALARS (or a documented PREFIXES family) or rename"
            )
        return self.make(module, node.lineno, msg, context=qual)


def config_field_map(
    config_path: str, tree: Optional[ast.Module] = None
) -> Dict[str, Dict[str, Optional[str]]]:
    """{ClassName: {field: nested-ClassName-or-None}} for every
    @dataclass in config.py, resolved the way add_flags recurses.
    Pass `tree` (the RepoContext.ast_of cache) to skip the re-parse."""
    if tree is None:
        with open(config_path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=config_path)
    classes: Dict[str, Dict[str, Optional[str]]] = {}
    names = {
        n.name for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
    }
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        fields: Dict[str, Optional[str]] = {}
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)):
                continue
            ann = stmt.annotation
            ann_name = getattr(ann, "id", getattr(ann, "attr", ""))
            fields[stmt.target.id] = ann_name if ann_name in names else None
        classes[node.name] = fields
    return classes


def flatten_flags(
    classes: Dict[str, Dict[str, Optional[str]]], root: str, prefix: str = ""
) -> Set[str]:
    out: Set[str] = set()
    for fname, nested in classes.get(root, {}).items():
        dotted = f"{prefix}{fname}"
        if nested is None:
            out.add(dotted)
        else:
            out |= flatten_flags(classes, nested, prefix=f"{dotted}.")
    return out


def argparse_flags(path: str, tree: Optional[ast.Module] = None) -> Set[str]:
    """--flag names from add_argument calls in a stdlib-argparse binary."""
    if tree is None:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    out: Set[str] = set()
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument"
        ):
            for arg in node.args:
                if (
                    isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith("--")
                ):
                    out.add(arg.value[2:])
    return out


@register
class ManifestFlagDrift(Rule):
    id = "OBS002"
    severity = "error"
    doc = "--flag in a k8s manifest that no binary defines"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        if not (ctx.config_path and os.path.exists(ctx.config_path)):
            return []
        classes = config_field_map(ctx.config_path, tree=ctx.ast_of(ctx.config_path))
        findings: List[Finding] = self._scripts_pass(ctx, classes)
        if not (ctx.k8s_dir and os.path.isdir(ctx.k8s_dir)):
            return findings
        for name in sorted(os.listdir(ctx.k8s_dir)):
            if not (name.endswith(".yaml") or name.endswith(".yml")):
                continue
            path = os.path.join(ctx.k8s_dir, name)
            rel = os.path.relpath(path, ctx.root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                lines = f.read().splitlines()
            stripped = [ln.split("#", 1)[0] for ln in lines]
            if not any(_BINARY_CONFIGS.get(m) for ln in stripped for m in binary_modules(ln)):
                continue  # manifest runs no binary we know (rabbitmq image)
            # A flag is judged against the namespace of the NEAREST
            # enclosing yaml sequence item that mentions a known binary
            # (the `-m dotaclient_tpu...` container block, for args and
            # env nested inside it). Flags with no such enclosing item —
            # a sidecar container's own --config, an annotation — belong
            # to some other program and are none of this rule's business.
            blocks = _item_blocks(stripped)
            resolved: Dict[int, Tuple[Set[str], Set[str]]] = {}
            for bi, (b_start, b_end, _indent) in enumerate(blocks):
                mods = set()
                for ln in stripped[b_start : b_end + 1]:
                    mods.update(binary_modules(ln))
                namespaces, known = self._namespaces(ctx, classes, mods)
                if known:
                    resolved[bi] = (namespaces, known)
            for lineno, ln in enumerate(stripped, start=1):
                flags = _FLAG_RE.findall(ln)
                if not flags:
                    continue
                enclosing = [
                    bi
                    for bi, (b_start, b_end, _indent) in enumerate(blocks)
                    if b_start <= lineno - 1 <= b_end and bi in resolved
                ]
                if not enclosing:
                    continue
                # innermost wins: blocks are emitted in document order,
                # so the last enclosing one starts deepest
                namespaces, known = resolved[enclosing[-1]]
                for flag in flags:
                    if flag not in namespaces:
                        findings.append(
                            self.make(
                                rel,
                                lineno,
                                f"--{flag} is not a flag of "
                                f"{'/'.join(sorted(known))} (config.py "
                                f"defines no such field) — the binary will "
                                f"refuse to start; fix the manifest or add "
                                f"the field",
                            )
                        )
        return findings

    def _scripts_pass(self, ctx: RepoContext, classes) -> List[Finding]:
        """The scripts/ half of OBS002: check subprocess-argv list
        literals in bench/soak drivers against the spawned binary's flag
        namespace. Only lists that NAME a known binary are judged — a
        script's own argparse flags (self-reinvocation lists) never
        mention a module and stay out of scope."""
        findings: List[Finding] = []
        for script in ctx.script_modules():
            rel = script.relpath
            for lst in ast.walk(script.tree):
                if not isinstance(lst, ast.List):
                    continue
                strs = [
                    e
                    for e in lst.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                ]
                mods: Set[str] = set()
                for e in strs:
                    mods.update(binary_modules(e.value))
                namespaces, known = self._namespaces(ctx, classes, mods)
                if not known:
                    continue
                for e in strs:
                    if not e.value.startswith("--"):
                        continue
                    flag = e.value[2:].split("=", 1)[0]
                    if flag and flag not in namespaces:
                        findings.append(
                            self.make(
                                rel,
                                e.lineno,
                                f"--{flag} is not a flag of "
                                f"{'/'.join(sorted(known))} (config.py "
                                f"defines no such field) — the spawned "
                                f"binary will refuse to start; fix the "
                                f"driver or add the field",
                            )
                        )
        return findings

    @staticmethod
    def _namespaces(
        ctx: RepoContext, classes, modules: Set[str]
    ) -> Tuple[Set[str], Set[str]]:
        """(flag namespace union, known modules) for a module set."""
        namespaces: Set[str] = set()
        known: Set[str] = set()
        for mod in sorted(modules):
            spec = _BINARY_CONFIGS.get(mod)
            if spec is None:
                continue
            known.add(mod)
            if spec.startswith("argparse:"):
                ap = os.path.join(
                    os.path.dirname(ctx.config_path), *spec.split(":", 1)[1].split("/")
                )
                if os.path.exists(ap):
                    namespaces |= argparse_flags(ap, tree=ctx.ast_of(ap))
            else:
                namespaces |= flatten_flags(classes, spec)
        return namespaces, known


@register
class UnconsumedFlag(Rule):
    id = "OBS003"
    severity = "warning"
    doc = "config field defined but never read anywhere in the package"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        if ctx.config_path is None or not os.path.exists(ctx.config_path):
            return []
        config_rel = os.path.relpath(ctx.config_path, ctx.root).replace(os.sep, "/")
        consumed: Set[str] = set()
        for module in ctx.modules:
            if module.relpath == config_rel:
                continue
            for sub in ast.walk(module.tree):
                if isinstance(sub, ast.Attribute):
                    consumed.add(sub.attr)
                elif (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "getattr"
                    and len(sub.args) >= 2
                    and isinstance(sub.args[1], ast.Constant)
                    and isinstance(sub.args[1].value, str)
                ):
                    # getattr(cfg, "field", default) — the compat-read idiom
                    consumed.add(sub.args[1].value)
        tree = ctx.ast_of(ctx.config_path)
        if tree is None:
            return []
        classes = config_field_map(ctx.config_path, tree=tree)
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef) or node.name not in classes:
                continue
            for stmt in node.body:
                if not (
                    isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                ):
                    continue
                fname = stmt.target.id
                if classes[node.name].get(fname) is not None:
                    continue  # nested config containers are structural
                if fname not in consumed:
                    findings.append(
                        self.make(
                            config_rel,
                            stmt.lineno,
                            f"{node.name}.{fname} is defined (and exposed as "
                            f"a --flag) but never read anywhere in the "
                            f"package — wire it or remove it",
                            context=node.name,
                        )
                    )
        return findings
