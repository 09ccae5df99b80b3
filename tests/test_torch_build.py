"""The kernel builder's cache key (no nvcc needed): a library is reused
only while its source, every ``csrc/`` header the source reaches through
``#include "..."``, and the flags are unchanged."""
from repro_torch.kernels import build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n'
                               "int k;\n")
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\nint b;\n")
    (csrc / "unused.cuh").write_text("int u;\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """Editing the source, a header it includes or one that header
    includes moves the library to a new path; a header nobody includes
    does not."""
    csrc = _tree(tmp_path, monkeypatch)
    first = build._library_path("k")
    assert first.name == "libk.so" and first.parent.parent == build.BUILD_DIR
    assert build._library_path("k") == first
    (csrc / "unused.cuh").write_text("int u2;\n")
    assert build._library_path("k") == first
    seen = {first}
    for name, text in (("b.cuh", "#pragma once\nint b2;\n"),
                       ("a.cuh", '#pragma once\n#include "b.cuh"\nint a;\n'),
                       ("k.cu", '#include "a.cuh"\nint k2;\n')):
        (csrc / name).write_text(text)
        path = build._library_path("k")
        assert path not in seen, name
        seen.add(path)


def test_sources_visits_each_header_once(tmp_path, monkeypatch):
    """Headers that include each other are each read once; system
    headers (``<...>``) and names that are not files under ``csrc/`` are
    skipped."""
    csrc = _tree(tmp_path, monkeypatch)
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n'
                                '#include "missing.cuh"\n')
    seen = set()
    build._sources(csrc / "k.cu", seen)
    assert sorted(p.name for p in seen) == ["a.cuh", "b.cuh", "k.cu"]
