"""Every public name of the JAX package has a counterpart in the port.

Pure ``ast``: neither package is imported. For each module of
``track_analyser_tpu/`` (except the two Pallas modules, whose
counterparts are ``ops/median.py`` and ``ops/fused_stft.py``):

(a) every name in the module's ``__all__`` (or, without one, every public
    top-level name it defines) is defined or re-exported by the port's
    module of the same path;
(b) every parameter of a public JAX function that a caller can pass by
    keyword is a parameter of the port's function of that name (the
    functions of (a), and any other public function the port defines).

What the port leaves out or renames on purpose stands in the two
allow-lists below, each entry with its reason; an entry that no longer
matches anything fails the run, so the lists cannot go stale.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "track_analyser_tpu"
PORT_PKG = ROOT / "track_analyser_tpu_torch"
# module of the JAX package -> why it has no counterpart of the same path
OTHER_COUNTERPART = {
    "ops/pallas_median.py": "the Pallas medians; the port's counterpart is ops/median.py (csrc/median31.cu)",
    "ops/pallas_stft.py": "the Pallas |STFT|; the port's counterpart is ops/fused_stft.py (csrc/stft_mag.cu)",
}

_MESH = "XLA mesh plumbing; the port's SeqGroup / make_group take its place (ROADMAP: deliberately not ported)"
_CLICK = "a click object; the port's CLI is argparse, cli.main (ROADMAP Queue 3: deliberate deviation)"
_JAX_DIR = "a path into the JAX package's directory; the port builds into build/torch_kernels/ (native/build.SRC)"

# (module, name) -> why the port's module does not define it
MISSING_NAMES = {
    ("cli.py", "cli"): _CLICK,
    ("cli.py", "analyze_command"): _CLICK,
    ("cli.py", "analyze_batch_command"): _CLICK,
    ("substrate.py", "jitted_full_track_graph"): "the jax.jit wrapper of full_track_graph; the port calls the graph itself",
    ("parallel/mesh.py", "make_mesh"): _MESH,
    ("parallel/mesh.py", "data_sharding"): _MESH,
    ("parallel/mesh.py", "replicated"): _MESH,
    ("parallel/mesh.py", "P"): _MESH,
    ("native/build.py", "HERE"): _JAX_DIR,
    ("native/build.py", "SRCS"): _JAX_DIR,
    ("native/build.py", "OUT"): _JAX_DIR,
    ("native/build.py", "FFMPEG_SRC"): _JAX_DIR,
    ("native/build.py", "FFMPEG_OUT"): _JAX_DIR,
}

_MODEL = "the port's nets are nn.Modules: it takes the module (params_from_jax converts a JAX params dict)"
_GENERATOR = "the port draws from a torch.Generator, not a JAX PRNG key"
_IN_MODEL = "carried by the BandSplitMaskNet module (read from its checkpoint by params_from_jax)"
_GROUP = "the port shards over a torch.distributed SeqGroup, not a JAX mesh axis (ROADMAP Queue 3: deliberate deviation)"

# (module, function, JAX parameter) -> (the port's parameter in its place or None, why)
RENAMED_PARAMS = {
    ("models/downbeat_net.py", "init_params", "key"): ("generator", _GENERATOR),
    ("models/downbeat_net.py", "init_tcn_params", "key"): ("generator", _GENERATOR),
    ("models/downbeat_net.py", "loss_fn", "params"): ("model", _MODEL),
    ("models/downbeat_net.py", "train_step", "params"): ("model", _MODEL),
    ("models/downbeat_net.py", "save_checkpoint", "params"): ("model", _MODEL),
    ("models/separation_net.py", "init_params", "key"): ("generator", _GENERATOR),
    ("models/separation_net.py", "forward_masks", "params"): ("model", _MODEL),
    ("models/separation_net.py", "forward_masks", "n_bands"): (None, _IN_MODEL),
    ("models/separation_net.py", "forward_masks", "dilations"): (None, _IN_MODEL),
    ("models/separation_net.py", "separate_signal", "params"): ("model", _MODEL),
    ("models/separation_net.py", "separate_signal", "dilations"): (None, _IN_MODEL),
    ("models/separation_net.py", "separate_signal_multi", "params"): ("model", _MODEL),
    ("models/separation_net.py", "separate_signal_multi", "dilations"): (None, _IN_MODEL),
    ("models/separation_net.py", "save_checkpoint", "params"): ("model", _MODEL),
    ("models/separation_net.py", "save_checkpoint", "dilations"): (None, _IN_MODEL),
    ("models/training.py", "separation_loss", "params"): ("model", _MODEL),
    ("models/training.py", "init_opt_state", "params"): ("model", _MODEL),
    ("models/training.py", "separation_train_step", "params"): ("model", _MODEL),
    ("parallel/sharded.py", "sharded_onset_envelope", "mesh"): ("group", _GROUP),
    ("parallel/sharded.py", "sharded_onset_envelope", "axis"): (None, _GROUP),
    ("parallel/sharded.py", "shard_halo_exchange", "axis_name"): ("group", _GROUP),
    ("parallel/sharded.py", "sharded_track_outputs", "mesh"): ("group", _GROUP),
    ("parallel/sharded.py", "sharded_track_outputs", "axis"): (None, _GROUP),
    ("parallel/sharded.py", "analyse_track_sharded", "mesh"): ("group", _GROUP),
    ("parallel/sharded.py", "analyse_track_sharded", "axis"): (None, _GROUP),
}


def _top_level(tree: ast.Module):
    """The module's top-level statements, those under if/try included."""

    stack = list(tree.body)
    while stack:
        node = stack.pop(0)
        if isinstance(node, ast.If):
            stack[:0] = node.body + node.orelse
        elif isinstance(node, ast.Try):
            stack[:0] = node.body + node.orelse + node.finalbody + [s for h in node.handlers for s in h.body]
        else:
            yield node


def _bindings(tree: ast.Module) -> "dict[str, ast.AST]":
    """Top-level name -> the statement that binds it."""

    out: "dict[str, ast.AST]" = {}
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                for leaf in ast.walk(target):
                    if isinstance(leaf, ast.Name):
                        out[leaf.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = node
    return out


def _dunder_all(tree: ast.Module) -> "list[str] | None":
    node = _bindings(tree).get("__all__")
    return None if node is None else list(ast.literal_eval(node.value))


def _forwarded(tree: ast.Module, bindings: "dict[str, ast.AST]") -> "set[str]":
    """Names a module-level ``__getattr__`` serves: the string literals of
    the collection it tests ``name in ...`` against."""

    getattr_fn = bindings.get("__getattr__")
    if not isinstance(getattr_fn, ast.FunctionDef):
        return set()
    names: "set[str]" = set()
    for cmp in ast.walk(getattr_fn):
        if isinstance(cmp, ast.Compare) and isinstance(cmp.ops[0], ast.In):
            target = cmp.comparators[0]
            if isinstance(target, ast.Name) and target.id in bindings:
                names |= set(ast.literal_eval(bindings[target.id].value))
    return names


def _public_names(tree: ast.Module) -> "list[str]":
    declared = _dunder_all(tree)
    if declared is not None:
        return declared
    return [
        name for name, node in _bindings(tree).items()
        if not name.startswith("_") and not isinstance(node, (ast.Import, ast.ImportFrom))
    ]


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _port_function(module: Path, name: str, depth: int = 0) -> "ast.FunctionDef | None":
    """The port's ``def`` behind ``name`` in ``module``, following the
    package's relative ``from .x import name`` re-exports."""

    node = _bindings(_parse(module)).get(name)
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return node
    if isinstance(node, ast.ImportFrom) and node.level and depth < 4:
        base = module.parent
        for _ in range(node.level - 1):
            base = base.parent
        target = base.joinpath(*(node.module or "").split("."))
        path = target.with_suffix(".py") if target.with_suffix(".py").is_file() else target / "__init__.py"
        original = next(a.name for a in node.names if (a.asname or a.name) == name)
        if path.is_file():
            return _port_function(path, original, depth + 1)
    return None


def _keyword_params(fn: ast.FunctionDef) -> "list[str]":
    return [a.arg for a in fn.args.args + fn.args.kwonlyargs]


def _modules() -> "list[str]":
    return sorted(
        str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py") if str(p.relative_to(JAX_PKG)) not in OTHER_COUNTERPART
    )


def surface_gaps(module: str) -> "tuple[list[str], set, set]":
    """(what the port lacks, the MISSING_NAMES keys used, the
    RENAMED_PARAMS keys used) for one JAX module."""

    jax_tree = _parse(JAX_PKG / module)
    port_path = PORT_PKG / module
    if not port_path.is_file():
        return [f"{module}: no module {port_path.relative_to(ROOT)}"], set(), set()
    port_tree = _parse(port_path)
    jax_bindings, port_bindings = _bindings(jax_tree), _bindings(port_tree)
    port_names = set(port_bindings) | set(_dunder_all(port_tree) or ()) | _forwarded(port_tree, port_bindings)
    gaps: "list[str]" = []
    used_names: set = set()
    used_params: set = set()
    public = _public_names(jax_tree)
    for name in public:
        if name not in port_names:
            if (module, name) in MISSING_NAMES:
                used_names.add((module, name))
            else:
                gaps.append(f"{module}: {name} is not in the port")
    # (b) covers the functions of (a), and every other public function that
    # the port defines under the same name (``istft`` is outside the JAX
    # ``__all__``, yet a caller passes its ``window``).
    functions = [
        name for name, node in jax_bindings.items()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and name in port_names
        and (name in public or not name.startswith("_"))
    ]
    for name in functions:
        port_fn = _port_function(port_path, name)
        if port_fn is None:
            if name not in _forwarded(port_tree, port_bindings):
                gaps.append(f"{module}: {name} is a function in JAX but not in the port")
            continue
        port_params = set(_keyword_params(port_fn))
        for param in _keyword_params(jax_bindings[name]):
            if param in port_params or port_fn.args.kwarg is not None:
                continue
            key = (module, name, param)
            if key not in RENAMED_PARAMS:
                gaps.append(f"{module}: {name}() takes no keyword {param!r} in the port")
                continue
            used_params.add(key)
            replacement = RENAMED_PARAMS[key][0]
            if replacement is not None and replacement not in port_params:
                gaps.append(f"{module}: {name}() has no {replacement!r} in place of {param!r}")
    return gaps, used_names, used_params


@pytest.mark.parametrize("module", _modules())
def test_the_port_has_the_public_surface_of(module: str) -> None:
    gaps, _, _ = surface_gaps(module)
    assert not gaps, "\n".join(gaps)


def test_every_allow_list_entry_is_needed_and_gives_its_reason() -> None:
    used_names: set = set()
    used_params: set = set()
    for module in _modules():
        _, names, params = surface_gaps(module)
        used_names |= names
        used_params |= params
    assert set(MISSING_NAMES) - used_names == set()
    assert set(RENAMED_PARAMS) - used_params == set()
    assert all(reason.strip() for reason in MISSING_NAMES.values())
    assert all(reason.strip() for _, reason in RENAMED_PARAMS.values())
    assert set(OTHER_COUNTERPART) <= {str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")}
    for counterpart in ("ops/median.py", "ops/fused_stft.py"):
        assert (PORT_PKG / counterpart).is_file()
