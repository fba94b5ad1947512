"""The port's annotation gate, the counterpart of
``chessvision_tpu/typecheck.py``, run over ``chessvision_tpu_torch``
with the standard library only:

1. every annotation in the package resolves (``from __future__ import
   annotations`` makes them lazy strings, so a renamed type or a dropped
   import stays invisible until ``typing.get_type_hints`` is called);
2. a parameter that defaults to ``None`` is typed Optional (mypy's
   ``no_implicit_optional``).

Run: ``python -m chessvision_tpu_torch.typecheck`` (exit 1 on findings);
tests/test_torch_typecheck.py runs it in the default suite.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import sys
import types
import typing
from typing import Any, Union

# Modules whose import has side effects unsafe for a checker process
# (none today).
_SKIP_MODULES: set[str] = set()


def _iter_package_modules(package_name: str = "chessvision_tpu_torch") -> list[types.ModuleType]:
    pkg = importlib.import_module(package_name)
    mods = [pkg]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=package_name + "."):
        if info.name in _SKIP_MODULES or info.name.endswith(".__main__"):
            continue  # __main__ shims run their CLI at import
        mods.append(importlib.import_module(info.name))
    return mods


def _is_optional(hint: Any) -> bool:
    origin = typing.get_origin(hint)
    if origin is Union or origin is types.UnionType:
        return type(None) in typing.get_args(hint)
    return hint is Any or hint is None or hint is type(None) or hint is inspect.Parameter.empty


def _check_callable(fn: Any, qualname: str, errors: list[str]) -> None:
    try:
        hints = typing.get_type_hints(fn)
    except Exception as e:  # noqa: BLE001 — any failure here IS the finding
        errors.append(f"{qualname}: unresolvable annotation: {type(e).__name__}: {e}")
        return
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return
    for name, param in sig.parameters.items():
        if param.default is None and name in hints and not _is_optional(hints[name]):
            errors.append(
                f"{qualname}: parameter '{name}' defaults to None but is "
                f"annotated {hints[name]!r} (not Optional)"
            )


def check_module(mod: types.ModuleType, errors: list[str]) -> None:
    mod_name = mod.__name__
    for name, obj in vars(mod).items():
        if getattr(obj, "__module__", None) != mod_name:
            continue  # re-exports are checked where they are defined
        if inspect.isfunction(obj):
            _check_callable(obj, f"{mod_name}.{name}", errors)
        elif inspect.isclass(obj):
            try:
                typing.get_type_hints(obj)
            except Exception as e:  # noqa: BLE001
                errors.append(
                    f"{mod_name}.{name}: unresolvable class annotation: "
                    f"{type(e).__name__}: {e}"
                )
            for mname, member in vars(obj).items():
                target = member
                if isinstance(member, (staticmethod, classmethod)):
                    target = member.__func__
                if inspect.isfunction(target) and target.__module__ == mod_name:
                    _check_callable(target, f"{mod_name}.{name}.{mname}", errors)
                elif isinstance(member, property) and member.fget is not None:
                    if member.fget.__module__ == mod_name:
                        _check_callable(member.fget, f"{mod_name}.{name}.{mname}", errors)


def run(package: str = "chessvision_tpu_torch") -> list[str]:
    """Check the whole package; returns the list of findings (empty = clean)."""
    errors: list[str] = []
    for mod in _iter_package_modules(package):
        check_module(mod, errors)
    return errors


def main() -> int:
    errors = run()
    n_mods = len(_iter_package_modules())
    if errors:
        print(f"typecheck: {len(errors)} finding(s) over {n_mods} modules:")
        for e in errors:
            print(f"  {e}")
        return 1
    print(f"typecheck: clean ({n_mods} modules, all annotations resolve)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
