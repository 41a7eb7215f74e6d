"""The kernel build's plan (``repro_torch.kernels.build``), run here with a
stand-in for ``nvcc`` (the CPU has none): every part of every source
compiles at once with its ``FAUST_PARTS``/``FAUST_PART`` flags, the parts
link into the source's one library, and a failing part raises and leaves
no library behind.  The card's build is ``chip_smoke.py``'s setup."""
from __future__ import annotations

import json
import stat
import sys

import pytest

from repro_torch.kernels import build

FAKE_NVCC = """#!{python}
import json, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    defs = sorted(a for a in args if a.startswith("-DFAUST_PART"))
    if "{fail}" and "{fail}" in args[-1] and "-DFAUST_PART=1" in defs:
        print("error: a part failed")
        sys.exit(1)
    with open(out, "w") as f:
        json.dump({{"source": args[-1].rsplit("/", 1)[-1], "defs": defs}}, f)
    print("ptxas info    : Used 40 registers (" + " ".join(defs) + ")")
else:
    with open(out, "w") as f:
        json.dump([json.load(open(a)) for a in args if a.endswith(".o")], f)
"""


def _fake_nvcc(tmp_path, monkeypatch, fail=""):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, fail=fail))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")


def test_every_part_compiles_and_links_into_one_library(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch)
    logs = build.build(("chain_wgrad", "bsr_matmul"))
    for name in ("chain_wgrad", "bsr_matmul"):
        n = build.PARTS.get(name, 1)
        parts = json.loads(build.library_path(name).read_text())
        assert parts == [{"source": build.SOURCES[name], "defs": [f"-DFAUST_PART={k}", f"-DFAUST_PARTS={n}"]}
                         for k in range(n)]
        assert logs[name].count("ptxas info") == n
    assert build.PARTS["chain_wgrad"] == 4
    assert [p.name for p in (tmp_path / "build").iterdir() if p.is_dir()] == []  # the parts' folders are gone
    assert build.build(("chain_wgrad",)) == {"chain_wgrad": logs["chain_wgrad"]}  # built: nothing compiles again


def test_a_failing_part_raises_and_leaves_no_library(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail="chain_dgrad")
    with pytest.raises(RuntimeError, match="chain_dgrad:\n(.|\n)*a part failed"):
        build.build(("chain_dgrad", "chain_matmul"))
    assert not build.library_path("chain_dgrad").exists()
    assert build.library_path("chain_matmul").exists()
    assert [p.name for p in (tmp_path / "build").iterdir() if p.is_dir()] == []
