"""The kernel build cache's key (`ops/_build.py::library_path`): it changes
when the source, a header beside it or a compiler flag changes, and not
otherwise. No `nvcc` is needed: only the path is computed, on a temporary
`csrc/`."""

import os

import pytest

from clip_event_tpu_torch.ops import _build
from tests.torch_multiprocess_worker import share_cores  # noqa: E402

share_cores()


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "tiles.cuh"\nint a;\n')
    (src / "b.cu").write_text("int b;\n")
    (src / "tiles.cuh").write_text("// tiles v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return src


def test_library_path_is_stable_and_inside_the_build_dir(csrc):
    first = _build.library_path("a")
    assert first == _build.library_path("a")
    assert os.path.dirname(first) == _build.BUILD_DIR
    assert os.path.basename(first).startswith("a-") and first.endswith(".so")
    assert _build.library_path("b") != first.replace("a-", "b-")  # keyed by the source too


@pytest.mark.parametrize("change", ["source", "header", "new_header", "flag"])
def test_library_path_changes_with(csrc, monkeypatch, change):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    if change == "source":
        (csrc / "a.cu").write_text('#include "tiles.cuh"\nint a2;\n')
    elif change == "header":
        (csrc / "tiles.cuh").write_text("// tiles v2\n")
    elif change == "new_header":
        (csrc / "frags.cuh").write_text("// fragments\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    # a header or a flag reaches every source; another source's edit does not
    assert (after["b"] != before["b"]) == (change != "source")


@pytest.mark.parametrize("change", ["touch", "other_file", "rewrite_same"])
def test_library_path_does_not_change_with(csrc, change):
    before = _build.library_path("a")
    if change == "touch":
        os.utime(csrc / "tiles.cuh", (1, 1))
    elif change == "other_file":
        (csrc / "notes.txt").write_text("not a header\n")
        (csrc / "c.cu").write_text("int c;\n")
    else:
        (csrc / "tiles.cuh").write_text("// tiles v1\n")
    assert _build.library_path("a") == before


def test_the_repo_sources_name_their_headers():
    """Every `#include "..."` of a kernel source is a `.cuh` beside it, so
    the cache key covers it; no header ends in `.cu` (the smoke script
    builds every `csrc/*.cu`)."""
    import re

    names = os.listdir(_build.CSRC_DIR)
    for name in names:
        assert name.endswith((".cu", _build.HEADER_SUFFIX)), name
        with open(os.path.join(_build.CSRC_DIR, name)) as fh:
            for inc in re.findall(r'#include\s+"([^"]+)"', fh.read()):
                assert inc.endswith(_build.HEADER_SUFFIX) and inc in names, (name, inc)
    assert "-I" not in _build.NVCC_FLAGS  # the include path is the live CSRC_DIR, added per build


def test_a_cached_library_keeps_its_compiler_output(csrc, tmp_path, monkeypatch):
    """The compiler's output (ptxas's registers and notes) is kept beside a
    library: a second build finds the library, takes 0 s, and still reads
    the output into BUILD_LOGS, so checks on it run on a cached build too.
    A stand-in for `nvcc` writes the library and prints one line."""
    import stat
    import sys

    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info    : Used 40 registers')\n"
    )
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    first = _build.build(["b"])
    assert first["b"] > 0.0 and "Used 40 registers" in _build.BUILD_LOGS["b"]
    assert os.path.exists(_build.library_path("b") + ".log")
    assert not [f for f in os.listdir(_build.BUILD_DIR) if ".tmp" in f]
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    again = _build.build(["b"])
    assert again == {"b": 0.0}
    assert "Used 40 registers" in _build.BUILD_LOGS["b"]
