"""The root ``conftest.py`` loads the JAX package's native table parser in
every test process before it collects (``tests/native_lib.py``'s locked
build), so ``tests/test_native.py``'s collection-time ``skipif`` finds the
library in every worker: where g++ exists, the loader holds a loaded
library and no cached build failure when any test starts."""

import shutil

import pytest

from socialways_tpu.native import loader


def test_torch_native_lib_is_loaded_before_collection():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native parser cannot be built here")
    assert loader._lib is not None
    assert loader._build_failed is False
    assert loader.get_lib() is loader._lib
