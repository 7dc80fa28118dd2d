"""The port is complete: every public top-level ``def`` or ``class`` of every
module under ``src/repro/``, and every public method of such a class, has a
counterpart of the same name in the matching ``src/repro_torch/`` module
(a class's methods may come from its bases in the port).  Read with
``ast`` alone: nothing is imported, JAX included.

``RENAMED`` maps what the port keeps under another name or in another
module; ``NOT_TO_PORT`` lists, with a reason each, what the port does not
carry (ROADMAP.md, Queue 1, "Not to port").
"""
import ast
import functools
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
JAX, PORT = SRC / "repro", SRC / "repro_torch"

#: JAX ``module:name`` -> the port's ``module:name`` holding it
RENAMED = {
    "core/gossip.py:consensus_error": "dtrain/api.py:consensus_error",
    "models/params.py:flatten_paths": "models/params.py:flatten",
    "models/perturb.py:Bundle.make": "models/perturb.py:Bundle.__init__",
    # the Trainer synchronises the device after every step itself, so a
    # method names no array to block on
    "dtrain/api.py:MethodBase.wall_handle": "dtrain/trainer.py:Trainer._sync",
    "dtrain/methods/seedflood.py:SeedFloodMethod.wall_handle":
        "dtrain/trainer.py:Trainer._sync",
}

_MESH = "a mesh hint: the port runs on one card and has no mesh"
_DRYRUN = ("an abstract input of the dry run, which lowers XLA programs "
           "for 256- and 512-chip TPU meshes")
_BACKEND = ("kernel_backend plumbing: the port dispatches on the tensor's "
            "device, with no knob")
_SCAN = ("a JAX pytree / lax.scan adaptor: the port's models take the flat "
         "path dicts and loop over the layer groups")

#: a JAX module (a prefix ending in "/" is a package) or ``module:name``
NOT_TO_PORT = {
    "analysis/": "sfcheck, the static checker, already sweeps the port",
    "kernels/ref.py": "the oracles are the plain version inside each "
                      "kernel wrapper of the port",
    "launch/dryrun.py": "lowers XLA programs for 256- and 512-chip TPU "
                        "meshes; no one-card counterpart",
    "launch/dryrun_all.py": "the dry run over every arch and shape",
    "roofline/analysis.py": "parses the dry run's HLO collectives; the "
                            "roofline terms came back through the cost model",
    "launch/mesh.py": _MESH,
    "launch/steps.py:cache_shardings": _MESH,
    "launch/steps.py:paged_pool_shardings": _MESH,
    "models/params.py:spec_partition": _MESH,
    "models/params.py:leaf_sharding": _MESH,
    "models/params.py:tree_shardings": _MESH,
    "models/params.py:subspace_shardings": _MESH,
    "launch/steps.py:serve_batch_inputs": _DRYRUN,
    "launch/steps.py:build_step": _DRYRUN,
    "models/params.py:abstract_params": _DRYRUN,
    "models/transformer.py:abstract_cache": _DRYRUN,
    "models/transformer.py:abstract_paged_pool": _DRYRUN,
    "kernels/ops.py:on_tpu": _BACKEND,
    "kernels/ops.py:set_default_backend": _BACKEND,
    "kernels/ops.py:get_default_backend": _BACKEND,
    "kernels/ops.py:default_backend": _BACKEND,
    "kernels/ops.py:resolve_backend": _BACKEND,
    "core/subcge.py:SubCGEConfig.backend": _BACKEND,
    "models/perturb.py:nest_subspace": _SCAN,
    "models/perturb.py:scan_xs": _SCAN,
}


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _top(tree: ast.Module) -> dict:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _bound(tree: ast.Module) -> set:
    """Every name a module binds at top level (definitions, assignments,
    imports)."""
    out = set(_top(tree))
    for n in tree.body:
        if isinstance(n, ast.Assign):
            out |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in n.names}
    return out


def _port_module(dotted: str) -> Path:
    rel = Path(*dotted.split(".")[1:])
    path = PORT / rel.with_suffix(".py")
    return path if path.exists() else PORT / rel / "__init__.py"


def _methods(path: Path, name: str) -> set:
    """The methods a port class has, its bases' (in the port) included."""
    tree = _tree(path)
    defs = _top(tree)
    imported = {a.asname or a.name: (n.module, a.name) for n in tree.body
                if isinstance(n, ast.ImportFrom)
                and (n.module or "").startswith("repro_torch")
                for a in n.names}
    if name in imported:
        module, orig = imported[name]
        return _methods(_port_module(module), orig)
    cls = defs.get(name)
    if not isinstance(cls, ast.ClassDef):
        return set()
    out = {b.name for b in cls.body
           if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for base in cls.bases:
        if isinstance(base, ast.Name):
            out |= _methods(path, base.id)
    return out


def _has(spec: str) -> bool:
    """Whether the port's ``module:name`` or ``module:Class.method`` exists."""
    module, name = spec.split(":")
    path = PORT / module
    if "." not in name:
        return name in _bound(_tree(path))
    cls, meth = name.split(".")
    return meth in _methods(path, cls)


def _skipped(rel: str, name: str = "") -> bool:
    return any(rel.startswith(k) if k.endswith("/") else k == rel
               for k in NOT_TO_PORT) or f"{rel}:{name}" in NOT_TO_PORT


def test_every_public_definition_has_a_counterpart():
    missing, checked = [], 0
    for path in sorted(JAX.rglob("*.py")):
        rel = path.relative_to(JAX).as_posix()
        if _skipped(rel):
            continue
        if not (PORT / rel).exists():
            missing.append(rel)
            continue
        for name, node in _top(_tree(path)).items():
            if name.startswith("_") or _skipped(rel, name):
                continue
            wants = [name]
            if isinstance(node, ast.ClassDef):
                wants += [f"{name}.{b.name}" for b in node.body
                          if isinstance(b, ast.FunctionDef)
                          and not b.name.startswith("_")]
            for want in wants:
                if _skipped(rel, want):
                    continue
                checked += 1
                spec = RENAMED.get(f"{rel}:{want}", f"{rel}:{want}")
                if not _has(spec):
                    missing.append(spec)
    assert not missing, f"no counterpart in src/repro_torch: {missing}"
    assert checked > 400
    # every exception and mapping names something that exists on its side
    for key in NOT_TO_PORT:
        rel, _, name = key.partition(":")
        assert (JAX / rel).exists(), key
        assert not name or name.split(".")[0] in _top(_tree(JAX / rel)), key
    for src, dst in RENAMED.items():
        module, name = src.split(":")
        top = name.split(".")[0]
        assert top in _top(_tree(JAX / module)), src
        assert _has(dst), dst
