"""A whole JAX test module's scenarios on the port, with no list of names
written by hand: what ``tests/torch_rebind.py`` does for the names a twin
file swaps one by one, worked out from the module's own imports.

* :func:`port_globals` — the port's object for each name the module
  imports from the JAX package at its top;
* :func:`port_twins` — ``torch_rebind.port_twins``, and each class the
  module defines rebuilt over the same globals (a JAX ``FakeClient``
  subclassed at import is the port's);
* :func:`port_modules_of` — ``torch_rebind.port_modules`` for every JAX
  module the file imports anywhere, a metrics module read through
  ``torch_rebind.PromView``;
* :func:`scenario_cases` — the cases less a named adapted set, by
  function or by case id; :func:`case_params` carries the JAX ``slow``
  mark;
* :func:`call_with_fixtures` — a scenario called with the fixtures the
  module defines, set up and torn down as pytest would."""

import ast
import contextlib
import importlib
import importlib.util
import inspect
import types

import pytest

import torch_rebind


def _jax_imports(module):
    """``(node, at module level)`` for each ``import``/``from ... import``
    of the JAX package in ``module``'s source."""
    tree = ast.parse(inspect.getsource(module))
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                (node.module or "").split(".")[0] == "tpu_operator":
            yield node, id(node) in top
        elif isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "tpu_operator" for a in node.names):
            yield node, id(node) in top


def _port_name(jax_name: str) -> str:
    return "tpu_operator_torch" + jax_name[len("tpu_operator"):]


def _metrics_read(obj):
    """A port ``*.metrics`` module as ``torch_rebind.metrics_view``, else
    ``obj``."""
    if isinstance(obj, types.ModuleType) and \
            obj.__name__.rsplit(".", 1)[-1] == "metrics":
        return torch_rebind.metrics_view(obj)
    return obj


def port_globals(module, **over) -> dict:
    """The port's object for each name ``module`` imports from the JAX
    package at its top (``from tpu_operator.x import y as z`` gives
    ``z``: the port's ``tpu_operator_torch.x.y``; a metrics module read
    through ``metrics_view``), ``over`` in place of any; for
    :func:`port_twins`."""
    out = {}
    for node, top in _jax_imports(module):
        if not top:
            continue
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = _metrics_read(importlib.import_module(
                        _port_name(a.name)))
            continue
        port = importlib.import_module(_port_name(node.module))
        for a in node.names:
            name = a.asname or a.name
            if name in over:
                continue
            out[name] = _metrics_read(
                getattr(port, a.name) if hasattr(port, a.name)
                else importlib.import_module(f"{port.__name__}.{a.name}"))
    out.update(over)
    return out


def _function(fn, names: dict, cells: list):
    """Method ``fn`` over the globals ``names``; its ``__class__`` cell
    (``super()``) a fresh one, appended to ``cells`` for its class."""
    closure = fn.__closure__
    if "__class__" in fn.__code__.co_freevars:
        closure = list(closure)
        cell = types.CellType()
        closure[fn.__code__.co_freevars.index("__class__")] = cell
        cells.append(cell)
        closure = tuple(closure)
    twin = types.FunctionType(fn.__code__, names, fn.__name__,
                              fn.__defaults__, closure)
    twin.__kwdefaults__ = fn.__kwdefaults__
    twin.__qualname__ = fn.__qualname__
    return twin


def _member(value, names: dict, cells: list):
    if inspect.isfunction(value):
        return _function(value, names, cells)
    if isinstance(value, (staticmethod, classmethod)):
        return type(value)(_member(value.__func__, names, cells))
    if isinstance(value, property):
        return property(*(f and _member(f, names, cells)
                          for f in (value.fget, value.fset, value.fdel)),
                        value.__doc__)
    return value


def _class(cls, names: dict, swap: dict):
    """``cls`` with each base in ``swap`` (by identity) replaced and its
    methods rebuilt over ``names``."""
    cells: list = []
    body = {k: _member(v, names, cells) for k, v in vars(cls).items()
            if k not in ("__dict__", "__weakref__")}
    twin = type(cls)(cls.__name__,
                     tuple(swap.get(id(b), b) for b in cls.__bases__), body)
    for cell in cells:
        cell.cell_contents = twin
    return twin


def port_twins(module, literals=None, **port_objects) -> dict:
    """``torch_rebind.port_twins``, then each class the module defines
    rebuilt over the same globals, in the module's order: its methods
    reach the port's objects, and a base swapped in ``port_objects`` (a
    JAX ``FakeClient`` subclassed), or a class rebuilt before it, is the
    twin's base."""
    names = torch_rebind.port_twins(module, literals, **port_objects)
    swap = {id(vars(module)[n]): v for n, v in port_objects.items()
            if isinstance(vars(module).get(n), type)}
    for name, cls in list(names.items()):
        if isinstance(cls, type) and cls.__module__ == module.__name__:
            names[name] = swap[id(cls)] = _class(cls, names, swap)
    return names


def _is_module(name: str) -> bool:
    try:
        return importlib.util.find_spec(_port_name(
            "tpu_operator" + (f".{name}" if name else ""))) is not None
    except ModuleNotFoundError:      # an attribute of a plain module
        return False


def port_modules_of(module, **views) -> dict:
    """``torch_rebind.port_modules`` for every JAX module (and its parent
    packages) that ``module`` imports anywhere, in a scenario's body too;
    a metrics module — and its package's ``metrics`` attribute, which
    ``from <package> import metrics`` reads — through ``metrics_view``."""
    names = {""}
    for node, _ in _jax_imports(module):
        mods = [a.name for a in node.names] if isinstance(node, ast.Import) \
            else [node.module] + [f"{node.module}.{a.name}"
                                  for a in node.names]
        for mod in mods:
            parts = mod.split(".")[1:]
            for i in range(1, len(parts) + 1):
                names.add(".".join(parts[:i]))
    names = sorted(n for n in names if _is_module(n))
    out = torch_rebind.port_modules(*names, **views)
    for name in names:
        if name.rsplit(".", 1)[-1] != "metrics" or \
                name.replace(".", "_") in views:
            continue
        parent, _, _ = name.rpartition(".")
        key = "tpu_operator" + (f".{parent}" if parent else "")
        out[f"tpu_operator.{name}"] = view = torch_rebind.metrics_view(
            out[f"tpu_operator.{name}"])
        out[key] = torch_rebind.module_view(out[key], metrics=view)
    return out


def scenario_cases(module, adapted=()) -> list:
    """``torch_rebind.scenario_cases`` less the ``adapted`` set, which
    names a function (all its cases) or one case by its id
    (``name[i]``)."""
    return [case for case in torch_rebind.scenario_cases(module)
            if case[0] not in adapted and case[1] not in adapted]


def case_params(module, cases) -> list:
    """``cases`` as ``pytest.param``s with their ids, each carrying the
    JAX scenario's ``slow`` mark where it has one."""
    return [pytest.param(*case, id=case[0], marks=[
        m for m in getattr(vars(module)[case[1]], "pytestmark", [])
        if m.name == "slow"]) for case in cases]


def call_with_fixtures(module, scenarios: dict, fn: str, kwargs: dict,
                       **builtin):
    """Call scenario ``fn`` with its case's arguments, each pytest
    fixture it names from ``builtin`` (``tmp_path``, ``monkeypatch``, …)
    or, where ``module`` defines that fixture, from its rebuilt body in
    ``scenarios`` (itself given its fixtures; a generator's teardown runs
    after the scenario, last set up first torn down)."""
    fixtures = {n for n, v in vars(module).items()
                if hasattr(v, "_get_wrapped_function")}
    with contextlib.ExitStack() as stack:
        def resolve(f, given):
            out = dict(given)
            for p in inspect.signature(f).parameters:
                if p in out:
                    continue
                if p in builtin:
                    out[p] = builtin[p]
                elif p in fixtures:
                    out[p] = provide(scenarios[p])
            return out

        def provide(body):
            value = body(**resolve(body, {}))
            if inspect.isgenerator(value):
                gen, value = value, next(value)
                stack.callback(next, gen, None)
            return value

        fn = scenarios[fn]
        return fn(**resolve(fn, kwargs))
