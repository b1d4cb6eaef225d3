"""Loads the JAX package's native table parser once, before any test
worker collects.

``tests/test_native.py`` decides at collection (a module-level ``skipif``
on ``socialways_tpu.native.loader.get_lib()``) whether its tests run, and
the loader builds ``libfastload.so`` into one fixed path under a lock
that only guards its own process.  Workers collecting together on a fresh
tree can load another worker's half-written library and keep None for the
rest of their lives, so those tests skip in some runs and not in others.
``pytest_configure`` runs once the initial conftests (``tests/conftest.py``
among them) are loaded, in the controlling process before its workers
start and again in each worker: there ``tests/native_lib.py`` builds or
loads the library under an ``fcntl`` lock, so one process builds and the
others load the finished file.  Without g++ the library stays None and
those tests skip, as before.
"""

import os
import sys


def pytest_configure(config):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from native_lib import _locked_get_lib
    _locked_get_lib()
