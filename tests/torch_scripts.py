"""Loads a script of the repo by its path, for the tests of the port's
user-facing scripts: ``examples/`` and ``examples_torch/`` hold modules of
the same names, and ``tools/`` is no package, so each script is loaded
under a name of its own, ``<directory>_<name>``, without touching
``sys.path``."""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(directory: str, name: str):
    """``<directory>/<name>.py`` as the module ``<directory>_<name>``."""
    module = f"{directory}_{name}"
    spec = importlib.util.spec_from_file_location(
        module, os.path.join(ROOT, directory, f"{name}.py"))
    mod = sys.modules[module] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
