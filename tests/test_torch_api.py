"""Call-signature parity: a call written for ``tpurt`` binds the same
arguments when it runs against ``tpurt_torch``.

Both packages are read as source with ``ast`` (neither is imported). For
every public function and public method of a public class that a module
of the reference and its counterpart in the port both define, the
reference's positional parameters must be the first positional
parameters of the port's, in order; every other parameter of the
reference must be accepted by name; and the port may require no
parameter the reference leaves optional. The port's own extras (chiefly
``device``) come after the reference's, keyword-only.
"""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# by design, with their reasons (ROADMAP §1, "Not ported, by design")
EXCEPTIONS = {
    # Pallas interpret mode: the port's CPU path is each kernel's plain
    # version, chosen by the tensor's device
    ("kernels/packet.py", "make_packet_intersector"): {"interpret"},
    ("kernels/pairwave.py", "make_pair_intersector"): {"interpret"},
    ("kernels/tilewave.py", "make_tile_intersector"): {"interpret"},
    # the port's "auto" is the reference's accelerator choice on every
    # device, so neither the platform nor the instanced triangle count
    # selects a path
    ("utils/config.py", "RenderConfig.resolved_intersector"): {
        "num_instanced_tris", "platform"},
    ("utils/config.py", "RenderConfig.resolved_pipeline"): {"platform"},
}


def _signatures(package: str) -> dict:
    """(module path in the package, public name) → ast.arguments, for
    top-level functions and the methods of top-level classes."""
    out = {}
    root = os.path.join(REPO, package)
    for folder, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(folder, name)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in tree.body:
                if not hasattr(node, "name") or node.name.startswith("_"):
                    continue
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[(rel, node.name)] = node.args
                elif isinstance(node, ast.ClassDef):
                    for m in node.body:
                        if (isinstance(m, ast.FunctionDef)
                                and not m.name.startswith("_")):
                            out[(rel, f"{node.name}.{m.name}")] = m.args
    return out


def _positional(a: ast.arguments) -> list:
    return [x.arg for x in a.posonlyargs + a.args]


def _required(a: ast.arguments) -> set:
    pos = a.posonlyargs + a.args
    need = {x.arg for x in pos[:len(pos) - len(a.defaults)]}
    return need | {x.arg for x, d in zip(a.kwonlyargs, a.kw_defaults)
                   if d is None}


def test_reference_calls_bind_the_same_arguments_in_the_port():
    ref, port = _signatures("tpurt"), _signatures("tpurt_torch")
    shared = sorted(set(ref) & set(port))
    assert len(shared) > 100  # the scan found the modules
    unused = set(EXCEPTIONS) - set(shared)
    assert not unused, f"stale exceptions: {unused}"
    bad = []
    for key in shared:
        r, p = ref[key], port[key]
        allowed = EXCEPTIONS.get(key, set())
        r_pos = [n for n in _positional(r) if n not in allowed]
        p_pos = _positional(p)
        if p_pos[:len(r_pos)] != r_pos:
            bad.append(f"{key}: positional {r_pos} -> {p_pos}")
        p_names = set(p_pos) | {x.arg for x in p.kwonlyargs}
        r_names = set(_positional(r)) | {x.arg for x in r.kwonlyargs}
        missing = r_names - p_names - allowed
        if missing and p.kwarg is None:
            bad.append(f"{key}: no parameter {sorted(missing)}")
        newly_required = _required(p) - _required(r)
        if newly_required:
            bad.append(f"{key}: requires {sorted(newly_required)}")
    assert not bad, "\n".join(bad)
