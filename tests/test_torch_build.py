"""The CUDA library's C interface against its ctypes bindings, read from
the sources alone (nothing is built): every ``extern "C"`` entry point of
``csrc/*.cu`` is bound in ``ops/_build.py``, every binding names an entry
point, and every entry point the port's Python names is bound.  A stale
binding then fails here, not when the library loads on the card."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pim_jpeg_decoder_tpu_torch")
CSRC = os.path.join(PORT, "csrc")
SOURCES = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _entry_points(source: str) -> set:
    return set(re.findall(r'extern "C"\s+\w+\s+(\w+)\s*\(',
                          _read(os.path.join(CSRC, source))))


def _bound() -> set:
    """The entry points whose argtypes the binding table of ``load`` sets."""
    return set(re.findall(r"\blib\.(pjt_cuda_\w+)\b",
                          _read(os.path.join(PORT, "ops", "_build.py"))))


@pytest.mark.parametrize("source", SOURCES)
def test_every_entry_point_is_bound(source):
    defined = _entry_points(source)
    assert defined, f"{source} defines no extern \"C\" entry point"
    assert defined <= _bound(), sorted(defined - _bound())


def test_every_binding_is_an_entry_point():
    defined = set().union(*(_entry_points(s) for s in SOURCES))
    assert _bound() and _bound() <= defined, sorted(_bound() - defined)


def test_every_entry_point_the_port_names_is_bound():
    """An entry point that Python calls without argtypes would pass its
    64-bit arguments as C ints."""
    named = set()
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]
        for name in files:
            if name.endswith(".py"):
                named |= set(re.findall(r"\b(pjt_cuda_\w+)\b",
                                        _read(os.path.join(root, name))))
    assert named and named <= _bound(), sorted(named - _bound())
