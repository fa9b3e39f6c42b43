"""Markdown API pages for prost_tpu_torch (counterpart of the JAX
package's ``docs/gen_api.py``).

``write_api(out_dir)`` walks every public module of the package with
``inspect`` and writes one Markdown page per module, plus an
``index.md``.  No doc tooling is needed.

    python -m prost_tpu_torch.docs OUT_DIR
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

PACKAGE = "prost_tpu_torch"


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + ln for ln in d.split("\n")) + "\n"


def _document_class(cls, lines):
    lines.append(f"### class `{cls.__name__}`\n")
    bases = [b.__name__ for b in cls.__bases__ if b is not object]
    if bases:
        lines.append(f"*Bases:* {', '.join(bases)}\n")
    lines.append(_doc(cls))
    for name, m in inspect.getmembers(cls):
        if name.startswith("_") and name != "__init__":
            continue
        if name not in cls.__dict__:
            continue  # only what this class defines, not what it inherits
        static = inspect.getattr_static(cls, name)
        if isinstance(static, staticmethod):
            lines.append(f"#### `{cls.__name__}.{name}{_sig(static.__func__)}`"
                         " (staticmethod)\n")
            lines.append(_doc(static.__func__))
        elif inspect.isfunction(m) or inspect.ismethod(m):
            label = "method" if name != "__init__" else "constructor"
            lines.append(f"#### `{cls.__name__}.{name}{_sig(m)}` ({label})\n")
            lines.append(_doc(m))
        elif isinstance(m, property):
            lines.append(f"#### `{cls.__name__}.{name}` (property)\n")
            lines.append(_doc(m.fget) if m.fget else "")
    lines.append("")


def document_module(modname: str) -> str:
    """The Markdown page of one module: its docstring, then its own
    functions and classes (re-exports are documented at their home)."""
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`\n", _doc(mod)]
    classes, functions = [], []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_") or getattr(obj, "__module__", None) != modname:
            continue
        if inspect.isclass(obj):
            classes.append(obj)
        elif inspect.isfunction(obj):
            functions.append(obj)
    if functions:
        lines.append("## Functions\n")
        for fn in functions:
            lines.append(f"### `{fn.__name__}{_sig(fn)}`\n")
            lines.append(_doc(fn))
    if classes:
        lines.append("## Classes\n")
        for cls in classes:
            _document_class(cls, lines)
    return "\n".join(lines)


def public_modules() -> list[str]:
    """The package and its public modules (no ``_``-prefixed part)."""
    pkg = importlib.import_module(PACKAGE)
    names = [PACKAGE]
    for _, name, _ in pkgutil.walk_packages(pkg.__path__, PACKAGE + "."):
        if any(part.startswith("_") for part in name.split(".")[1:]):
            continue
        names.append(name)
    return sorted(names)


def write_api(out_dir: str) -> list[str]:
    """Write one page per public module (``<module with _ for .>.md``) and
    ``index.md`` into ``out_dir``; returns the page file names."""
    os.makedirs(out_dir, exist_ok=True)
    index = [f"# {PACKAGE} API reference\n",
             f"Generated by `python -m {PACKAGE}.docs`.  One page per "
             "module:\n"]
    pages = []
    for modname in public_modules():
        fname = modname.replace(".", "_") + ".md"
        with open(os.path.join(out_dir, fname), "w") as fh:
            fh.write(document_module(modname))
        index.append(f"- [`{modname}`]({fname})")
        pages.append(fname)
    with open(os.path.join(out_dir, "index.md"), "w") as fh:
        fh.write("\n".join(index) + "\n")
    return pages


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(f"usage: python -m {PACKAGE}.docs OUT_DIR")
    print(f"wrote {len(write_api(sys.argv[1]))} module pages to "
          f"{sys.argv[1]}")
