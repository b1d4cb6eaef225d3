"""The JAX package's native table parser, loaded without a build race.

``socialways_tpu/native/loader.py:get_lib`` builds ``libfastload.so`` on
first use into one fixed path, guarded only by a lock inside the process:
test workers that start together on a fresh tree can load another
worker's half-written library and then keep None for the whole process,
so JAX's default ``load()`` silently takes its line loop.  The port's
parser tests compare against that default, so they load the library here
first: under an ``fcntl`` lock on a file beside it (one worker builds, the
others wait and load the finished file), and once more after clearing
the loader's cached failure if the first try still got None (a worker
that does not take the lock, such as the JAX package's own tests, may
have been writing the file)."""

import fcntl
import shutil

from socialways_tpu.native import loader


def _locked_get_lib():
    with open(loader._LIB + ".lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)       # released when fh closes
        return loader.get_lib()


def load_native(monkeypatch):
    """``loader.get_lib()`` for this process, built race-free; None only
    on a host without g++ or where the build itself fails."""
    lib = _locked_get_lib()
    if lib is None and shutil.which("g++"):
        monkeypatch.setattr(loader, "_lib", None)
        monkeypatch.setattr(loader, "_build_failed", False)
        lib = _locked_get_lib()
    return lib
