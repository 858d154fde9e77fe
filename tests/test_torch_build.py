"""The port's kernel build, with a stand-in compiler: concurrent builders
compile once, and a current stamp skips the compiler altogether."""

import sys
import threading

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = f"""#!{sys.executable}
import pathlib, sys, time
args = sys.argv[1:]
log = pathlib.Path(__file__).with_name("calls.log")
with open(log, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(0.2)
pathlib.Path(args[args.index("-o") + 1]).write_text("built")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build_dir, tools = (tmp_path / d for d in ("csrc", "build", "bin"))
    for d in (csrc, tools):
        d.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    nvcc = tools / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc, build_dir, tools / "calls.log"


def _calls(log):
    return log.read_text().split() if log.exists() else []


@pytest.mark.parametrize("builders", [1, 4])
def test_concurrent_builders_compile_once(fake_tree, builders):
    _, build_dir, log = fake_tree
    paths, errors = [], []

    def run():
        try:
            paths.append(_build.build())
        except Exception as exc:  # surfaced by the assert below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(builders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert paths == [build_dir / _build.LIB_NAME] * builders
    assert sorted(_calls(log)) == ["compile", "compile", "link"]
    assert (build_dir / _build.LIB_NAME).read_text() == "built"


def test_rebuild_only_when_a_source_changes(fake_tree):
    csrc, _, log = fake_tree
    _build.build()
    _build.build()
    assert len(_calls(log)) == 3
    (csrc / "a.cu").write_text("// changed\n")
    _build.build()
    assert len(_calls(log)) == 6
