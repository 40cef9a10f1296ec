"""The package's former import name, kept so that code written against it
still imports.  It is an alias: ``<this name>.X`` resolves to the very
module ``rangeclip.X``, so classes and module state are shared.  New code
imports ``rangeclip``."""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import rangeclip

_OLD = __name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.X`` to the already-importable ``rangeclip.X``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module("rangeclip" + spec.name[len(_OLD):])

    def exec_module(self, module):
        pass


if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
warnings.warn(f"{_OLD} is renamed rangeclip; import rangeclip instead",
              DeprecationWarning, stacklevel=2)
sys.modules[_OLD] = rangeclip
