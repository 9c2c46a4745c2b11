"""Runtime: device resolution, the process group and the device mesh, the
launcher and its membership store.

PEP 562 lazy exports, as in the JAX package's ``runtime/__init__.py``:
``launch``, ``membership`` and ``recovery_drill`` start as the launcher's
processes and must not import torch (only the launcher's children touch
the card), so nothing here imports a submodule until it is asked for.
Name -> source submodule; None = the submodule itself.
"""

_LAZY = {
    "dist": None,
    "mesh": None,
    "ports": None,
    "launch": None,
    "membership": None,
    "recovery_drill": None,
    "find_free_port": "ports",
}


def __getattr__(name):
    try:
        submodule = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    from importlib import import_module

    if submodule is None:
        return import_module(f".{name}", __name__)
    return getattr(import_module(f".{submodule}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = ["dist", "mesh", "launch", "membership", "recovery_drill", "find_free_port"]
